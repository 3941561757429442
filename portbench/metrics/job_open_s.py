"""Seconds of the job's opening (run.py _run_mapping up to the first read:
the outputs, Log.out, the BAM collector, Transcriptome.load and Solo(...)
with its whitelist), once a job: pipeline.TIMERS job_open."""


def read(rec):
    return rec["timers"].get("job_open")
