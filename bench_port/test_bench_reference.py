"""The plain references against the port, on the CPU at the reduced
sizes: a prefill and greedy decode steps of the port, teacher-forced
through the reference."""
import numpy as np
import pytest
import torch

from bench_port import check, spec
from bench_port.conftest import reduced
from bench_port.reference import moe as ref_moe
from bench_port.reference.plain import fp8, matmul
from bench_port.weights import make_weights

CELLS = ["olmoe-1b-7b.code_long_prompt", "mamba2-2.7b.code_long_prompt"]


def _port_greedy(model, w, prompt, steps, max_len):
    logits, caches = model.prefill(w, prompt[None], pad_cache_to=max_len)
    rows, served = [logits[0].float()], [int(logits[0].argmax())]
    for i in range(steps):
        tok = torch.tensor([[served[-1]]])
        pos = torch.tensor([[len(prompt) + i]])
        logits, caches = model.decode_step(w, tok, caches, pos)
        rows.append(logits[0].float())
        served.append(int(logits[0].argmax()))
    return torch.stack(rows), torch.tensor(served)


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port(name):
    from repro_torch.models import build
    cell = reduced(name)
    cfg = spec.model_config(cell.config)
    model = build(cfg)
    w = make_weights(model, 2 ** 31 + 3, "cpu", cell.config.get("init"))
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, 150), dtype=torch.long)
    port, served = _port_greedy(model, w, prompt, 6, 192)
    ref = check.reference_of(cell.config).served_logits(
        w, cell.config["model"], prompt, served)
    port = port[:, :cfg.vocab_size]
    # 8 bf16 epsilons of the largest reference logit: the port computes
    # on bf16 operands, the reference in f32
    assert (port - ref).abs().max() <= 8 * 2 ** -8 * ref.abs().max()
    gaps = ref.max(-1).values - ref.gather(1, served[:, None])[:, 0]
    assert gaps.max() <= 8 * 2 ** -8 * ref.abs().max()
    low = check.reference_of(cell.config).served_logits(
        w, cell.config["model"], prompt, served, "fp8")
    assert (low - ref).abs().max() > (port - ref).abs().max()


def test_capacity_rule_is_the_ports():
    from repro_torch.models.moe import dispatch
    g = torch.Generator().manual_seed(5)
    top_e = torch.stack([torch.randperm(4, generator=g)[:2]
                         for _ in range(60)])
    top_e[:30, 0] = 1                 # one expert over its capacity
    cap = 20
    _, keep = dispatch(top_e, 4, cap)
    mine = ref_moe.capacity_keep(top_e, 4, cap)
    assert torch.equal(mine.reshape(-1), keep)
    assert not bool(mine.all())


def test_fp8_rounds_each_slice_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -448.0], [1e-3, 2e-3, 3e-3]])
    q = fp8(x, -1)
    assert q[0, 2] == -448.0 and q[0, 0] == 1.0
    assert torch.allclose(q[1], x[1], rtol=2 ** -3)
    assert not torch.equal(q, x)
    w = torch.eye(3)
    assert torch.equal(matmul(x, w, "f32"), x)
    with pytest.raises(ValueError):
        matmul(x, w, "int3")
