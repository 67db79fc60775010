"""Per-model serving frontier — port of :mod:`repro.traces.frontier`.

For every (model, QPS) point a synthetic serving trace is generated
(:func:`~repro_torch.traces.synthetic.synthetic_serving_trace` — config
shapes only, no weights), the whole batch is evaluated through the
``trace`` axis in ONE design-space evaluation (one trace-scan run per
engine family: on the card one ``symmetric_trace`` and one
``asymmetric_trace`` launch), and the winning flit-simulated protocol
(duration-weighted ``trace_bandwidth_gbs`` on the target PHY) is mapped to
its catalog memory approach.  The report is the ``serving_frontier``
section of ``design_space.json``; its winner labels are held to the
checked-in summary golden.

QPS sensitivity is the point: low-QPS traces sit at drained backlogs and
decode-heavy read fractions, high-QPS traces saturate the queue and mix
in prefill write bursts, so the winning approach can flip along the QPS
axis — a frontier the static-mix sections cannot express.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.traces.model_traffic import ModelTrafficSpec
from repro_torch.traces.synthetic import synthetic_serving_trace

#: model configs the committed artifact sweeps: a dense decoder, a MoE
#: (expert-shuffle bytes), and an SSM (context-independent state reads)
DEFAULT_MODELS: Tuple[str, ...] = ("smollm-360m", "olmoe-1b-7b",
                                   "mamba2-2.7b")
#: requests per engine tick — drained, at-capacity, and saturated
#: regimes (the default batch has 32 slots serving ~128-token decodes,
#: so its service rate is 0.25 req/tick: 0.05 drains to a shallow queue
#: where the asymmetric approaches win, 1.0 and 4.0 pile up backlog
#: where the optimized symmetric protocol takes over)
DEFAULT_QPS: Tuple[float, ...] = (0.05, 1.0, 4.0)


def serving_frontier(models: Sequence[str] = DEFAULT_MODELS,
                     qps_points: Sequence[float] = DEFAULT_QPS, *,
                     phy: Any = None,
                     protocols: Optional[Sequence[str]] = None,
                     n_phases: int = 6, n_ticks: int = 384,
                     batch_slots: int = 32, arrival: str = "diurnal",
                     seed: int = 0, sim=None, device=None
                     ) -> Dict[str, Any]:
    """Build the per-(model, QPS) serving-frontier report on ``device``
    (default ``"cuda"``).

    ``phy`` defaults to the paper's UCIe-A 32G point; ``sim`` is the
    trace engine's :class:`~repro_torch.core.space.SimConfig` (fixed
    trace-scan core by default).  Winner labels are catalog approach keys
    (``A:lpddr6-asym`` ...), the vocabulary the summary golden holds.
    ``launches`` counts the trace kernels the evaluation launched (0 on
    the CPU, which runs their plain versions)."""
    from repro_torch import device as device_mod
    from repro_torch.core import flitsim
    from repro_torch.core.selector import approach_key_for
    from repro_torch.core.space import DesignSpace, axis
    from repro_torch.core.ucie import UCIE_A_32G_55U
    from repro_torch.kernels.flit_sim import ops as fs_ops

    dev = device_mod.resolve(device)
    if phy is None:
        phy = UCIE_A_32G_55U
    traces = [
        synthetic_serving_trace(
            ModelTrafficSpec.from_name(m), qps=q, n_ticks=n_ticks,
            n_phases=n_phases, batch_slots=batch_slots, arrival=arrival,
            seed=seed, name=f"{m}@q{q:g}")
        for m in models for q in qps_points]

    before = {k: fs_ops.launches[k] for k in fs_ops.TRACE_KERNELS}
    axes = [axis("trace", traces)]
    if protocols is not None:
        axes.append(axis("protocol", protocols))
    res = DesignSpace(axes, phy=phy, sim=sim, device=dev).evaluate(
        metrics=("trace_efficiency", "trace_bandwidth_gbs"))
    launches = {k: fs_ops.launches[k] - n for k, n in before.items()}

    bw = res["trace_bandwidth_gbs"]             # [protocol, trace]
    best = bw.argbest("protocol")               # [trace]
    best_gbs = bw.best("protocol")
    names = list(bw.coord("trace"))

    winner: Dict[str, Dict[str, str]] = {}
    proto: Dict[str, Dict[str, str]] = {}
    gbs: Dict[str, Dict[str, float]] = {}
    for i, m in enumerate(models):
        winner[m], proto[m], gbs[m] = {}, {}, {}
        for j, q in enumerate(qps_points):
            k = str(best.values[i * len(qps_points) + j])
            qkey = f"{q:g}"
            proto[m][qkey] = k
            winner[m][qkey] = approach_key_for(k)
            gbs[m][qkey] = float(
                best_gbs.values[i * len(qps_points) + j])

    tele = {fam: info for fam, info in flitsim.last_run_info().items()
            if info.get("mode") == "trace"}
    return {
        "models": list(models),
        "qps_points": [float(q) for q in qps_points],
        "phy": phy.name,
        "arrival": arrival,
        "n_ticks": int(n_ticks),
        "n_phases": int(max(t.n_phases for t in traces)),
        "protocols": list(bw.coord("protocol")),
        "trace_names": names,
        "winner_by_model_qps": winner,
        "protocol_by_model_qps": proto,
        "winner_gbs_by_model_qps": gbs,
        "qps_sensitive": {
            m: len(set(winner[m].values())) > 1 for m in models},
        "traces": {
            t.name: {"durations": list(t.durations),
                     "read_fractions": list(t.read_fractions),
                     "backlogs": list(t.backlogs)}
            for t in traces},
        "telemetry": tele,
        "launches": launches,
    }
