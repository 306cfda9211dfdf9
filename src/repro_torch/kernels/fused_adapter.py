"""CUDA kernel wrapper: the unbatched fused bottleneck adapter.

Replaces the Pallas TPU kernel ``src/repro/kernels/fused_adapter.py:46``
(``fused_adapter``, ``pallas_call`` at ``:58``): ``y = x + act(LN(x·Â))·B̂``
for x [T, d] with one Â [d, b] / B̂ [b, d]. It computes the B=1 form of
the batched kernel (``csrc/fused_adapter.cu``, see
``kernels/fused_adapter_batched.py`` for its bound and design), so it
launches that kernel on a [1, T, d] view of x with batch stride 0 for the
shared operands: no copy. At B=1 the grid is one thread-block cluster
per 16-token tile (T=256: 16 clusters of 8 blocks), each block taking a
d-slice, x·Â on tensor cores in bf16.

On a CPU tensor the wrapper computes the plain version
(``kernels/ref.py`` ``fused_adapter_ref``); on a CUDA tensor it launches
the kernel or raises. ``fused_adapter.launches`` counts its launches.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.fused_adapter_batched import launch
from repro_torch.utils import PLAIN_DEVICES


def fused_adapter(x, a_hat, b_hat, ln_scale, ln_bias, *,
                  activation: str = "gelu", use_ln: bool = True):
    """x [T, d]; a_hat [d, b]; b_hat [b, d] (one dtype with x, bf16 or
    fp32); ln_* [b] fp32, or None with ``use_ln=False`` -> [T, d] in x's
    dtype."""
    if x.device.type in PLAIN_DEVICES:
        return ref.fused_adapter_ref(x, a_hat, b_hat, ln_scale, ln_bias,
                                     activation=activation, use_ln=use_ln)
    if x.ndim != 2 or a_hat.ndim != 2 or b_hat.ndim != 2 \
            or any(t is not None and t.ndim != 1
                   for t in (ln_scale, ln_bias)):
        raise ValueError("the unbatched adapter takes x [T, d], a_hat "
                         "[d, b], b_hat [b, d] and ln_* [b]")
    out = launch(x[None], a_hat, b_hat, ln_scale, ln_bias,
                 activation=activation, use_ln=use_ln)[0]
    fused_adapter.launches += 1
    return out


fused_adapter.launches = 0
