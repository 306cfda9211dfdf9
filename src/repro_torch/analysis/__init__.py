"""Analytic cost accounting: bank and record bytes (``bytes.py``), the
three-term roofline with the useful-FLOP count on the H100's constants
(``roofline.py``), and the op-stream cost of a step (``op_cost.py``: the
counterpart of JAX's ``hlo_cost.analyze``, ``attribute`` and
``hlo.collective_bytes``, reading the aten ops a step dispatches where
JAX reads compiled HLO)."""
from repro_torch.analysis.bytes import (  # noqa: F401
    admission_bank_bytes, aggregation_bytes, bank_slice_bytes, itemsize_for,
    record_bytes, row_bytes, tree_nbytes)
from repro_torch.analysis.op_cost import collective_bytes  # noqa: F401
from repro_torch.analysis.roofline import (  # noqa: F401
    model_flops, roofline_terms)
