"""star_tpu_torch: the star_tpu aligner in PyTorch, with its device kernels
written by hand in CUDA C++ for NVIDIA Hopper (sm_90a).

Same layout and module names as star_tpu, which stays the reference the port
is tested against:
  * genome/, align/, io/, quant/, utils/, params, stats, constants: host
    stages (index build and junction insertion, BAM, quantification,
    signal, dedup, liftOver among them), copied from star_tpu (the port
    imports nothing of star_tpu);
  * ops/fetch.py + ops/csrc/fetch_rows.cu: the byte-window fetch kernel
    that serves every random access of the suffix-array search and the
    device stitch engine;
  * ops/sa_search.py: batched MMP search over device-resident index tensors;
  * ops/pipeline.py: the seed loop on the device, DeviceAligner;
  * ops/batch_engine.py: the numpy windows/stitch/extend engine;
  * run.py: the genomeGenerate, alignReads (one or two passes), liftOver
    and inputAlignmentsFromBAM entry points (``python -m star_tpu_torch``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
