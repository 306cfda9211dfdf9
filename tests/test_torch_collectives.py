"""The port's compressed collectives and GPipe pipeline on four gloo ranks
on the CPU, against JAX's arithmetic on one device.

One spawn of four ranks (``python -c``, a ``FileStore`` under the test's
tmp dir) on a 4-rank ``pod`` mesh runs ``compressed_psum`` on each
rank's shard of a seeded [4, 64] array, 20 steps of
``compressed_psum_ef`` and ``tree_compressed_psum_ef``, and
``pipeline_apply`` of an 8-layer tanh stack (4 stages of 2 layers, 6
microbatches) with its backward.

Contracts: ``compressed_psum`` BITWISE equal to JAX's
``quantize_int8``/``dequantize_int8`` arithmetic on the stacked shards
(scale from the max over all of them, int32 sum); the error-feedback
mean over 20 steps within JAX's 0.01 of the exact sum (relative to its
max); the pipeline's outputs within JAX's 1e-4 of the sequential stack
computed by JAX on the same numpy inputs, and its gradients (each
stage's layers, the microbatches on stage 0) within 1e-4 of
``jax.grad`` of the sequential stack's sum.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.distributed.collectives import dequantize_int8, quantize_int8

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
S, L, D, M = 4, 8, 16, 6

WORKER = textwrap.dedent(r'''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                            rank=rank, world_size=world)
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.pipeline import pipeline_apply, stack_stages
    from repro_torch.launch.mesh import make_test_mesh

    data = np.load(sys.argv[4])
    mesh = make_test_mesh((world,), ("pod",))
    group = mesh.get_group("pod")
    x = torch.from_numpy(data["shards"][rank])
    out = {"psum": C.compressed_psum(x, group).numpy()}
    err = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    errs = {"g": {"a": torch.zeros_like(x)}}
    for _ in range(20):
        y, err = C.compressed_psum_ef(x, err, group)
        acc = acc + y
        ty, errs = C.tree_compressed_psum_ef({"g": {"a": x}}, errs, group)
        assert torch.equal(ty["g"]["a"], y)
    out["ef_mean"] = (acc / 20).numpy()

    w = torch.from_numpy(data["layers"]).requires_grad_()
    xm = torch.from_numpy(data["x_micro"]).requires_grad_()

    def stage_fn(p, h):
        for l in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][l])
        return h

    y = pipeline_apply(stage_fn, stack_stages({"w": w}, world), xm, mesh,
                       axis="pod")
    y.sum().backward()
    out["pipe"] = y.detach().numpy()
    out["grad_w"] = w.grad.numpy()
    out["grad_x"] = xm.grad.numpy()
    dist.barrier()
    dist.destroy_process_group()
    np.savez(sys.argv[5] % rank, **out)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    data = dict(
        shards=rng.standard_normal((S, 64)).astype(np.float32),
        layers=(rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(
            np.float32),
        x_micro=rng.standard_normal((M, 4, D)).astype(np.float32))
    np.savez(tmp / "data.npz", **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(S), str(tmp / "store"),
         str(tmp / "data.npz"), str(tmp / "out%d.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(S)]
    for rank, p in enumerate(procs):
        _, err = p.communicate(timeout=300)
        if p.returncode:
            pytest.fail(f"rank {rank} exited {p.returncode}:\n{err[-6000:]}")
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(S)]


def test_compressed_psum_bitwise_jax_arithmetic(runs):
    data, ranks = runs
    x = jnp.asarray(data["shards"])
    scale = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0
    q = jnp.stack([quantize_int8(x[r], scale) for r in range(S)])
    want = np.asarray(dequantize_int8(q.astype(jnp.int32).sum(0), scale))
    for r in ranks:
        assert r["psum"].tobytes() == want.tobytes()
    exact = data["shards"].sum(0)
    assert np.abs(want - exact).max() / np.abs(exact).max() < 0.05


def test_compressed_psum_error_feedback_mean(runs):
    data, ranks = runs
    exact = data["shards"].sum(0)
    for r in ranks:
        rel = np.abs(r["ef_mean"] - exact).max() / np.abs(exact).max()
        assert rel < 0.01, rel


def _sequential(layers, x_micro):
    def one(x):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, layers)[0]
    return jax.vmap(one)(x_micro)


def test_pipeline_matches_sequential_stack(runs):
    data, ranks = runs
    want = np.asarray(_sequential(jnp.asarray(data["layers"]),
                                  jnp.asarray(data["x_micro"])))
    for r in ranks:
        assert np.abs(r["pipe"] - want).max() < 1e-4


def test_pipeline_gradients_match_jax_grad(runs):
    """Each stage's own layers get the sequential stack's gradient, and
    stage 0 (which feeds the microbatches in) the inputs' gradient."""
    data, ranks = runs
    gw, gx = jax.grad(lambda w, x: _sequential(w, x).sum(), argnums=(0, 1))(
        jnp.asarray(data["layers"]), jnp.asarray(data["x_micro"]))
    per = L // S
    for s, r in enumerate(ranks):
        mine = slice(s * per, (s + 1) * per)
        assert np.abs(r["grad_w"][mine] - np.asarray(gw)[mine]).max() < 1e-4
        others = np.delete(r["grad_w"], np.arange(s * per, (s + 1) * per),
                           axis=0)
        assert not others.any()
    assert np.abs(ranks[0]["grad_x"] - np.asarray(gx)).max() < 1e-4
