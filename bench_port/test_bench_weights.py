"""The weights: made from the seed in the port's parameter layout, with
the published initialisers a configuration file names."""
import math

import torch
import torch.nn.functional as F

from bench_port import spec
from bench_port.conftest import reduced
from bench_port.weights import make_weights


def _model(name):
    from repro_torch.models import build
    cell = reduced(name)
    return cell, build(spec.model_config(cell.config))


def test_same_seed_same_weights_in_the_ports_layout():
    cell, model = _model("olmoe-1b-7b.code_long_prompt")
    a = make_weights(model, 2 ** 31 + 1, "cpu")
    b = make_weights(model, 2 ** 31 + 1, "cpu")
    c = make_weights(model, 2 ** 31 + 2, "cpu")
    ref = model.init(torch.Generator().manual_seed(0))
    flat = lambda t: {k: v for k, v in _leaves(t)}
    fa, fb, fc, fr = flat(a), flat(b), flat(c), flat(ref)
    assert fa.keys() == fr.keys()
    for k in fa:
        assert fa[k].shape == fr[k].shape and fa[k].dtype == torch.float32
        assert torch.equal(fa[k], fb[k])
    assert not torch.equal(fa["embedding.embed"], fc["embedding.embed"])
    assert torch.equal(fa["blocks.layer_00.ln1.scale"],
                       torch.ones_like(fa["blocks.layer_00.ln1.scale"]))
    d = model.cfg.d_model
    std = fa["blocks.layer_00.attn.wq"].std().item()
    assert abs(std * math.sqrt(d) - 1.0) < 0.1


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def test_published_initialisers():
    cell, model = _model("mamba2-2.7b.code_long_prompt")
    init = cell.config["init"]
    plain = dict(_leaves(make_weights(model, 9, "cpu")))
    pub = dict(_leaves(make_weights(model, 9, "cpu", init)))
    k = "blocks.layer_01.ssm."
    assert torch.allclose(pub[k + "out_proj"],
                          plain[k + "out_proj"] * init["out_proj"]["scale"])
    a = torch.exp(pub[k + "a_log"])
    assert a.min() >= 1.0 and a.max() <= 16.0 and a.std() > 1.0
    dt = F.softplus(pub[k + "dt_bias"])
    assert dt.min() >= 0.001 * 0.999 and dt.max() <= 0.1 * 1.001
    assert torch.equal(pub[k + "d_skip"], plain[k + "d_skip"])
    b = pub[k + "conv_b"]
    assert b.min() >= -0.5 and b.max() <= 0.5 and b.std() > 0.2
