"""The output check decides ``correct`` by a comparison that fails: the
harness's whole run (set-up, window, check) on small cells on the CPU,
with the chip's look skipped, passes as it stands and comes out not
correct with the timed path broken underneath (a token altered where it
is produced; a decode step that returns its cache unchanged), and the
fp8 control fails the limit a bf16 program meets."""
import pytest
import torch

from perfbench import harness
from perfbench.reference import common
from perfbench.tests.small import small_cell


def judge(cell, out):
    return harness.passed(harness.verdict(cell, out["readings"]))


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_sound_run_is_correct(kind, loop):
    cell, cfg = small_cell(kind, loop)
    out = harness.run_cell(cell, 2 ** 31 + 77, 2.0, False, device="cpu",
                           model_cfg=cfg)
    assert judge(cell, out), out["readings"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _token_altered(monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    orig = ServeEngine._select_next

    def select(self, logits, act):
        return (orig(self, logits, act) + 1) % logits.shape[-1]
    monkeypatch.setattr(ServeEngine, "_select_next", select)


def _state_unchanged(monkeypatch):
    from repro_torch.models.registry import ModelBundle
    orig = ModelBundle.paged_decode_step

    def step(self, params, cache, *args, **kw):
        copy = {k: (v if not isinstance(v, dict) else {
            n: ({m: t.clone() for m, t in x.items()} if isinstance(x, dict)
                else x.clone()) for n, x in v.items()})
            for k, v in cache.items()}
        logits, _ = orig(self, params, copy, *args, **kw)
        return logits, cache
    monkeypatch.setattr(ModelBundle, "paged_decode_step", step)


@pytest.mark.parametrize("number", harness.GAPS)
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, kind, number):
    fault(monkeypatch)
    cell, cfg = small_cell(kind, number=number)
    out = harness.run_cell(cell, 5, 0.6, False, device="cpu", model_cfg=cfg)
    assert not judge(cell, out), out["readings"]


def drained(kind: str, seed: int, n: int = 12, **over):
    """The cell's engine served ``n`` requests of its traffic to the end
    (no clock: the same tokens on every machine)."""
    from repro_torch.serve import Request
    from perfbench.loadgen import Traffic
    cell, cfg = small_cell(kind, **over)
    bundle, params = harness.build(cell.config, seed, "cpu", cfg)
    eng = harness.engine(bundle, params, cell.traffic, seed)
    traffic = Traffic(cell.traffic, seed, cell.config["model"]["vocab_size"])
    infos = []
    for k in range(n):
        prompt, budget = traffic.request(k)
        req = Request(rid=k, prompt=prompt, max_new_tokens=budget)
        eng.add_request(req)
        infos.append(harness.Info(req, 0.0))
    eng.run_to_completion()
    return cell, params, infos


@pytest.mark.parametrize("number", harness.GAPS)
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_fp8_control_fails_the_limit_bf16_meets(kind, number):
    """At a width a test holds, in bf16: the program's gap (widest or mean)
    over three seeds, the control's at the same positions, and a limit
    between them with the cells' rule (the control at three times the
    program or more)."""
    control = number.replace("logit", "control")
    prog, ctrl = [], []
    # the MoE at its published 40 experts, top 8: at the smoke's 4, top 2,
    # one bf16 routing flip moves half a layer's output
    experts = (dict(num_experts=40, num_experts_per_tok=8) if kind == "moe"
               else {})
    for seed in (1, 2, 3):
        cell, params, infos = drained(kind, seed, dtype="bfloat16",
                                      d_model=256, num_layers=2,
                                      vocab_size=2048, **experts)
        cell.check["sample_requests"] = 12
        r = harness.check_outputs(cell, params, infos, seed,
                                  torch.device("cpu"), control=True)
        assert r["tokens_compared"] >= 60
        prog.append(r[number])
        ctrl.append(r[control])
    floor = 0.01 if number == "logit_gap_max" else 1e-4
    assert min(ctrl) >= 3 * max(max(prog), floor), (prog, ctrl)
    cell.check = {"min_tokens": 10, number: (max(prog) + min(ctrl)) / 2}
    assert judge(cell, dict(readings={number: max(prog),
                                      "tokens_compared": 50}))
    assert not judge(cell, dict(readings={number: min(ctrl),
                                          "tokens_compared": 50}))


def test_check_needs_tokens():
    cell, _ = small_cell("dense")
    assert not judge(cell, dict(readings=dict(logit_gap_max=0.0,
                                              tokens_compared=0)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_small_cell_on_the_card(card, kind):
    cell, cfg = small_cell(kind, dtype="bfloat16", d_model=128,
                           num_layers=2, vocab_size=512, gap=0.2)
    out = harness.run_cell(cell, 3, 1.0, True, device="cuda", model_cfg=cfg)
    assert judge(cell, out), out["readings"]
    assert out["records"]["slice"]["n_device_ops"] > 0
    common.exact_float32()
