"""Layout-experiment tools of the port: kernels B5 (wide KV view) and B6
(head-major KV cache), each beside kernel B2 in a timed sweep.

Counterparts of the JAX repository's ``tools/bench_pa_wide.py`` and
``tools/bench_pa_headmajor.py``. Importing a module here runs nothing; each
sweep runs as ``python -m blazr_tpu_torch.tools.<module> [B ...]`` on the
card.
"""
