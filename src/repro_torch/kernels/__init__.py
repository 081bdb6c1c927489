"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``), dispatched by ``ops.py``:

  * edge_block_spmm — chunk aggregation as a segmented reduction (K1)
  * fused_graduate  — graduation transform act(x @ W + b) (K2)
  * flash_attention — causal GQA attention for LM prefill, with an
                      optional sliding window (K3)
  * ssd_chunk       — the Mamba-2 SSD chunk scan (K4)
  * rms_norm        — RMSNorm, every norm of the LM stack (K5)
  * rglru_scan      — the RG-LRU linear recurrence (K6, port-only)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  ``_build.py`` compiles the sources in
``repro_torch/csrc`` with nvcc on first use.
"""
