"""Analytic cost accounting: bank and record bytes (``bytes.py``) and the
three-term roofline with the useful-FLOP count (``roofline.py``), on the
H100's constants. ``collective_bytes``, which reads compiled HLO text,
has no counterpart yet: it waits for the dry-run slice, which decides what
the port counts in its place."""
from repro_torch.analysis.bytes import (  # noqa: F401
    admission_bank_bytes, aggregation_bytes, bank_slice_bytes, itemsize_for,
    record_bytes, row_bytes, tree_nbytes)
from repro_torch.analysis.roofline import (  # noqa: F401
    model_flops, roofline_terms)
