"""Host seconds of the batch's arrays (ops/pipeline.py _align_batch: the
read matrix and chain descriptors before the seed loop, the fwd / rc /
nmm_max arrays before the stitch) per million reads of the window:
pipeline.TIMERS batch_arrays."""


def read(rec):
    v = rec["timers"].get("batch_arrays")
    if v is None or not rec["reads"]:
        return None
    return v / rec["reads"] * 1e6
