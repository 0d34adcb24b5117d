"""Hand-written CUDA kernels for the data planes (sources in ``csrc/``).

* ``segment_reduce`` — K1, fused gather + tiled segment reduction with a
  sum, min or max per column: DBIndex pass 1 and pass 2 of every query
  (min/max ride it when the plan has no ELL layout).
* ``bitset_expand``  — K2, one BFS hop over packed bitsets: the
  affected-owner BFS of streamed updates.
* ``flash_attention`` — K3, causal GQA flash attention forward: the dense
  LM's prefill.  Two kernels, routed on (dtype, D): bf16 with D 64 or 128
  on the tensor cores (``csrc/flash_attention_sm90.cu``), the rest on the
  CUDA cores (``csrc/flash_attention.cu``).
* ``fm_interaction`` — K4, the FM second-order interaction: the FM
  recsys model's forward.
* ``inherit_scan`` — the I-Index's inheritance scan along the PID forest
  (the level schedule of paper Algorithm 5), a sum, min or max per column:
  the topological window's query after its K1 pass.  It replaces no Pallas
  kernel (the reference scans in ``jnp``).

Each kernel module holds the wrapper (launch count, input checks) and a
plain PyTorch version of the same function, which CPU tensors take and
which is the kernel's oracle; ``build.py`` compiles the sources with
``nvcc`` at first use.
"""
