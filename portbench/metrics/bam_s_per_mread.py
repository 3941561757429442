"""Host seconds of BAM output (io/bam.py: per-read encoding and the finish:
sort, BGZF) per million reads of the window: pipeline.TIMERS bam_encode +
bam_finish."""


def read(rec):
    keys = ['bam_encode', 'bam_finish']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
