"""The port's quantized-bank serving against the JAX package, on the CPU:
int4 on the composed decode path, and int8/int4 with ``decode_fused=True``
(each decode step runs the megakernel's int8/int4 route once per layer;
on the CPU its plain version).

Workload, fixtures and tolerances are ``test_torch_quant_serve.py``'s:
reduced qwen1.5-0.5b at float32, 4 hard-mask profiles (two with
quantized aggregated store records), 6 requests on 3 slots; greedy
tokens equal to JAX's quantized engine on the same route, or differing
only on a float32 tie (JAX top-2 gap below 1e-4).
"""
import pytest

from repro_torch.models import model as TMDL
from test_torch_quant_serve import base  # noqa: F401 (fixture)
from test_torch_quant_serve import check_engine_against_jax


@pytest.mark.parametrize("scheme,fused", [("int4", False), ("int8", True),
                                          ("int4", True)])
def test_quant_engine_routes_match_jax(base, scheme, fused):  # noqa: F811
    eng = check_engine_against_jax(base, scheme, fused)
    # the decode step's route: the megakernel's quantized one, or composed
    route = TMDL._decode_fused_route(eng.cfg, eng.masks, True, 1)
    assert route == (scheme if fused else None)
