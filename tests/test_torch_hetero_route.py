"""The hetero-adapter route: one launch where a cluster holds every
stage's tiles, else the stages as their own kernels (#2 -> #2's LoRA
route -> #7), decided by ``kernels/hetero_adapter.cluster_for``.

At dbrx-132b's d (6144) a bottleneck + LoRA entry fits at T=1 only, and
at llava-next-34b's (7168) at no T: there ``ops.hetero_adapter`` runs
the three kernels, whose own planners take those shapes in bf16. On the
CPU every wrapper computes its plain version, so the route's output
equals the one launch's plain version bitwise; the wrappers are spied
to see which ran.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import fused_adapter_batched as KF
from repro_torch.kernels import hetero_adapter as KH
from repro_torch.kernels import ops, ref

B, b = 2, 64


@pytest.mark.parametrize("arch,T,route", [
    ("qwen1.5-0.5b", 1, "one"), ("qwen1.5-0.5b", 16, "one"),
    ("dbrx-132b", 1, "one"), ("dbrx-132b", 4, "separate"),
    ("dbrx-132b", 16, "separate"), ("llava-next-34b", 1, "separate"),
    ("llava-next-34b", 16, "separate")])
def test_route_decision_at_config_widths(arch, T, route):
    d = get_config(arch).d_model
    x = torch.zeros((B, T, d), dtype=torch.bfloat16)
    a = torch.zeros((B, d, b), dtype=torch.bfloat16)
    bb = torch.zeros((B, b, d), dtype=torch.bfloat16)
    ln = torch.zeros((B, b))
    stages = {"bottleneck": (a, bb, ln, ln), "lora": (a, bb),
              "ia3": torch.zeros((B, d), dtype=torch.bfloat16)}
    assert ops.hetero_route(x, stages) == route
    # the separate route's kernels take every one of these shapes
    assert KF.plan(d, b, T, 2) in KF.CLUSTERS
    if route == "separate":
        with pytest.raises(ValueError, match="no cluster"):
            KH.plan(d, [b, b], T, 2, 2)


@pytest.mark.parametrize("nb", [8, 4, 0, KH.MAX_B + 16])
def test_route_keeps_widths_the_launch_cannot_take_on_one(nb):
    """A stage width that is no whole number of 16-byte vectors in [1,
    MAX_B] stays on the one launch, whose planner refuses it on the card
    (the CPU's plain version takes it)."""
    d = 1024
    x = torch.zeros((B, 4, d), dtype=torch.bfloat16)
    stages = {"lora": (torch.zeros((B, d, nb), dtype=torch.bfloat16),
                       torch.zeros((B, nb, d), dtype=torch.bfloat16))}
    assert ops.hetero_route(x, stages) == "one"
    if nb == 8:
        assert KH.plan(d, [nb], 4, 2) in KH.CLUSTERS
    else:
        with pytest.raises(ValueError, match="16-byte"):
            KH.plan(d, [nb], 4, 2)


@pytest.mark.parametrize("d,route", [(1024, "one"), (7168, "separate")])
def test_route_runs_the_stages_in_order(monkeypatch, d, route):
    calls = []
    for name in ("_fused_cuda_batched", "_ia3_cuda", "_hetero_cuda"):
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, kw.get("use_ln")))
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16, scale=0.05):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)

    x = rnd(B, 4, d, scale=1.0)
    masks = {"a_hat": rnd(B, d, b), "b_hat": rnd(B, b, d),
             "ln_scale": rnd(B, b, dtype=torch.float32, scale=1.0),
             "ln_bias": rnd(B, b, dtype=torch.float32),
             "lora_a": rnd(B, d, b), "lora_b": rnd(B, b, d),
             "ia3_s": rnd(B, d)}
    got = ops.hetero_adapter(x, masks, activation="gelu", impl="auto")
    want = ref.hetero_adapter_batched_ref(
        x, bottleneck=tuple(masks[k] for k in ops.HETERO_STAGES["bottleneck"]),
        lora=(masks["lora_a"], masks["lora_b"]), ia3=masks["ia3_s"],
        activation="gelu")
    assert torch.equal(got, want)
    if route == "one":
        assert calls == [("_hetero_cuda", None)]
    else:
        assert calls == [("_fused_cuda_batched", True),
                         ("_fused_cuda_batched", False), ("_ia3_cuda", None)]
