"""Host seconds of filling the batches from the reader (ops/pipeline.py
align_stream: the FASTQ parse and the wait on the pipe) per million reads
of the window: pipeline.TIMERS read_input."""


def read(rec):
    v = rec["timers"].get("read_input")
    if v is None or not rec["reads"]:
        return None
    return v / rec["reads"] * 1e6
