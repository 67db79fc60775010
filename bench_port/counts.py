"""The yardstick's arithmetic: the card's peaks, the least work and bytes
of each kernel the benchmark holds to a roofline, and the model FLOPs of a
served token, summed over its layers' parts (``parts/<part>.py``, one file
a part; :data:`LAYER_PARTS` says which parts a kind of layer has).

The counts do not depend on how a kernel is implemented: causal attention
counts only the key positions each query reads, the SSD scan counts its
recurrence (not the chunked form's, nor 3xTF32's, extra work), and a
kernel's bytes are its inputs read once and its outputs written once.
"""
from __future__ import annotations

import collections
import functools
import importlib.util
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

PARTS_DIR = Path(__file__).resolve().parent / "parts"

#: the parts of each layer kind of the port (``ModelConfig.layer_kinds``);
#: a configuration file's ``layer_parts`` adds a kind or replaces one
LAYER_PARTS = {"attn": ("attention", "mlp"), "moe": ("attention", "moe"),
               "ssm": ("ssd",)}

#: NVIDIA H100 SXM5 80 GB, dense rates (NVIDIA's data sheet; the port's
#: ``roofline/hw.py`` holds the same two values)
PEAK_BF16 = 989e12        # FLOP/s, bf16 operands on the tensor cores
PEAK_TF32 = 495e12        # FLOP/s, f32 operands on the tensor cores
HBM_BW = 3.35e12          # bytes/s


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time of ``flops`` at ``peak`` and ``nbytes`` at
    :data:`HBM_BW`: the larger of the two."""
    return max(flops / peak, nbytes / HBM_BW)


def flash_attn(s: int, heads: int, kv_heads: int, hd: int,
               window: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of causal self-attention over ``s`` positions, bf16:
    ``QK^T`` and ``PV`` over the (query, key) pairs the mask keeps,
    ``s(s+1)/2`` causal, and where ``window`` > 0 only the last ``window``
    keys of each query; q, k, v read once, the output written once."""
    w = window if 0 < window < s else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    flops = 4.0 * heads * hd * pairs
    nbytes = 2.0 * s * hd * (2 * heads + 2 * kv_heads)
    return flops, nbytes


def flash_attn_bound_s(s, heads, kv_heads, hd, window=0) -> float:
    return bound_s(*flash_attn(s, heads, kv_heads, hd, window), PEAK_BF16)


def ssd_scan(s: int, heads: int, p: int, n: int,
             init_state: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of the SSD recurrence over ``s`` steps, f32: a step
    of a head decays its ``[P, N]`` state (``P N`` multiplies), adds the
    outer product ``dt x B^T`` (``2 P N``) and reads it out against ``C``
    (``2 P N``).  Read once: x ``[S, H, P]``, dt ``[S, H]``, B and C
    ``[S, N]``, ``a_log`` ``[H]`` and the initial state; written once: y
    ``[S, H, P]`` and the final state ``[H, P, N]``."""
    flops = 5.0 * s * heads * p * n
    words = (2 * s * heads * p + s * heads + 2 * s * n + heads
             + heads * p * n * (2 if init_state else 1))
    return flops, 4.0 * words


def ssd_scan_bound_s(s, heads, p, n, init_state=False) -> float:
    return bound_s(*ssd_scan(s, heads, p, n, init_state), PEAK_TF32)


def window_of(cfg) -> int:
    """The positions a local-attention layer reads at most; 0 for full
    attention."""
    return cfg.window if cfg.attention == "local" else 0


@functools.lru_cache(maxsize=None)
def part(name: str) -> Callable:
    """``parts/<name>.py``'s ``flops(cfg, context)``: the model FLOPs of
    one token in one layer's part, reading ``context`` positions (a whole
    number, or a NumPy array of them: a prefill counts all its positions
    in one call, so a part caps with ``np.minimum``)."""
    path = PARTS_DIR / f"{name}.py"
    if "/" in name or name.startswith(".") or not path.is_file():
        raise ValueError(
            f"no FLOP count for the layer part {name!r}: add "
            f"bench_port/parts/{name}.py with flops(cfg, context), and "
            f"name it in the configuration file's layer_parts")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_port.parts.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.flops


def layers(cfg, config: Optional[Dict] = None) -> List[Tuple[int, Tuple]]:
    """(how many layers, their parts) for each layer kind of ``cfg``, the
    parts by :data:`LAYER_PARTS` and the configuration file ``config``'s
    ``layer_parts``, which adds kinds or replaces these."""
    table = {**LAYER_PARTS, **(config or {}).get("layer_parts", {})}
    out = []
    for kind, n in collections.Counter(cfg.layer_kinds()).items():
        if kind not in table:
            raise ValueError(
                f"no parts for a {kind!r} layer: map it to its parts in "
                f"the configuration file's layer_parts, each part a file "
                f"bench_port/parts/<part>.py")
        out.append((n, tuple(table[kind])))
    return out


def layers_with(cfg, name: str, config: Optional[Dict] = None) -> int:
    """How many of ``cfg``'s layers have the part ``name``."""
    return sum(n for n, parts in layers(cfg, config) if name in parts)


def token_flops(cfg, context, config: Optional[Dict] = None):
    """Model FLOPs of one token that reads ``context`` positions (itself
    included), without the LM head: the sum of its layers' parts (2 x the
    matmul parameters each uses, attention's ``4 x context x H x hd``, the
    SSD recurrence's ``5 x H x P x N``)."""
    return sum(n * sum(part(p)(cfg, context) for p in parts)
               for n, parts in layers(cfg, config))


def lm_head_flops(cfg) -> float:
    return 2.0 * cfg.d_model * cfg.vocab_size


def prefill_flops(cfg, s: int, config: Optional[Dict] = None) -> float:
    """A prefill of ``s`` tokens: every position's layers (position ``i``
    reads ``i + 1``), one LM head (the engine reads the last position's
    logits only)."""
    contexts = np.arange(1, s + 1)
    per_token = token_flops(cfg, contexts, config)
    return float(np.broadcast_to(per_token, contexts.shape).sum()) \
        + lm_head_flops(cfg)


def decode_flops(cfg, position: int, config: Optional[Dict] = None) -> float:
    """A decoded token at absolute ``position`` (it reads ``position + 1``
    positions) with its LM head."""
    return float(token_flops(cfg, position + 1, config)) + lm_head_flops(cfg)
