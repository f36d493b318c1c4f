"""PyTorch/CUDA port of the MuLoCo reproduction (``repro``), for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
layout so each counterpart is found under the same path. It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.
Importing it compiles nothing: the Hopper kernels under ``kernels/csrc``
are built with ``nvcc`` at their first launch (``kernels/_build.py``).

Ported so far: serving (``python -m repro_torch.launch.serve``, the paged
and naive engines) and MuLoCo training (``python -m repro_torch.launch.train``,
with the compressed, streaming, elastic and data-parallel paths and the
captured round) for all six model families and every configuration of the
reference, the paper's pseudogradient analysis, and the roofline tooling
(``repro_torch.roofline``). ``ROADMAP.md`` lists what is still to come
(multi-GPU, the rest of the tooling).
"""

__version__ = "0.1.0"
