"""The plain reference against the port on the CPU, at the port's smoke
widths of each model, float32: a prefill's last logits, then each decode
step's, through the port's dense entry points and through its paged
engine."""
import numpy as np
import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import common, dense, moe
from perfbench.tests.small import small_cell, small_model

KINDS = {"dense": dense, "moe": moe}


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_prefill_then_decode_logits(kind):
    from repro_torch.models import RuntimeFlags, build
    cfg, config = small_model(kind)
    dims = config["model"]
    bundle = build(cfg, RuntimeFlags(**config["flags"]), device="cpu")
    params = weights.draw(dims, 1234, torch.float32, "cpu")
    weights.check_against(params, bundle.abstract_params()[0])
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, dims["vocab_size"], 13))
    cache, logits = bundle.prefill(params, dict(tokens=prompt[None]))
    seq = prompt.tolist()
    port = [logits[0]]
    full = bundle.init_cache(1, 32)
    # decode through the dense cache: write the prompt's rows first
    for name, layer in cache["blocks"].items():
        for n, t in layer.items():
            full["blocks"][name][n][:, :, :t.shape[2]] = t
    tok = int(logits[0].argmax())
    for step in range(5):
        seq.append(tok)
        lg, full = bundle.decode_step(params, full,
                                      torch.tensor([[tok]]),
                                      torch.tensor([len(seq) - 1]))
        port.append(lg[0])
        tok = int(lg[0].argmax())
    h = common.hidden_states(params, dims, KINDS[kind].ffn,
                             torch.as_tensor(seq))
    ref = (h @ common.head(params))[len(prompt) - 1:]
    port = torch.stack(port)
    assert torch.allclose(port, ref, atol=2e-4, rtol=0), \
        float((port - ref).abs().max())


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_paged_engine_tokens_are_the_references_best(kind):
    cell, cfg = small_cell(kind)
    out = harness.run_cell(cell, 99, 0.5, False, device="cpu",
                           model_cfg=cfg)
    r = out["readings"]
    assert r["tokens_compared"] >= 10
    assert r["logit_gap_max"] < 1e-4


def test_fp8_linear_rounds():
    x = torch.randn(4, 64)
    w = torch.randn(64, 32)
    exact = x @ w
    got = common.fp8_linear(x, w)
    rel = float((got - exact).abs().max() / exact.abs().max())
    assert 1e-3 < rel < 0.2
