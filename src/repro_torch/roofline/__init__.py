"""Roofline tooling (port of ``repro/roofline``): analytic FLOP and byte
counts (:mod:`.flops`), the terms and peaks of one H100 (:mod:`.analysis`),
the per-program terms and the measured record (:mod:`.terms`) and the
tables (:mod:`.report`).

The reference's ``roofline/hlo.py`` has no twin: it parses XLA's optimized
HLO text for the bytes of on-mesh collectives, and a PyTorch program has no
such text. On one card the collective term is 0; the bytes a round's
pseudogradient sync moves come from the sizes of its wire buffers
(``repro_torch.core.collectives.measured_sync_bytes``) into the wire term.
Neither has ``parse_collective_bytes`` a twin, for the same reason.
"""
from repro_torch.roofline.analysis import (  # noqa: F401
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    RooflineTerms,
    active_params,
    model_flops,
)
