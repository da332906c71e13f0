"""Hand-written CUDA kernels for the package's compute hot spots.

Each kernel directory mirrors its ``repro.kernels`` counterpart:
  kernel.py - the wrapper that launches the CUDA kernel (source under
              ``repro_torch/csrc``), the plain PyTorch version of the same
              function beside it, and the launch count
  ops.py    - the public entry point (sort, edge conversion, dispatch)
  ref.py    - an independent oracle used by the tests

  lifetime_scan   - GainSight's frontend hot loop: segmented lifetime
                    extraction + histogram over sorted event streams
  flash_attention - attention forward (``kernel.py``) and its two backward
                    passes (``kernel_bwd.py``), differentiable through
                    ``ops.flash_attention``
  ssd_scan        - Mamba-2's chunked state-space scan
  cache_replay    - the cache backend's hot loop: set-parallel LRU
                    write-back replay of one cache level (``ops.py``
                    partitions the stream by set; there is no ``ref.py``:
                    the reference's scalar replay in
                    ``backends/cachesim.py`` is the oracle)

``_build.py`` compiles the sources with ``nvcc`` at first launch.
"""
