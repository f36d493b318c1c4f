"""PyTorch/CUDA port of the MuLoCo reproduction (``repro``), for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
layout so each counterpart is found under the same path. It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.
Importing it compiles nothing: the Hopper kernels under ``kernels/csrc``
are built with ``nvcc`` at their first launch (``kernels/_build.py``).

Ported so far: the paged serving path (``python -m repro_torch.launch.serve``)
of the dense family. ``ROADMAP.md`` lists what is still to come.
"""

__version__ = "0.1.0"
