"""Run driver: alignReads.

The port's run surface is alignReads with SAM, SJ.out.tab and log outputs,
single- and paired-end, with outFilterType BySJout and unmapped-read FASTX
output (reference: source/STAR.cpp dispatch).  The device path runs the seed
search on the GPU (ops/pipeline.py DeviceAligner); the host runs the rest.
Options whose stages are not ported yet stop the run with a message that
names them.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

from .params import Parameters
from .genome.index import GenomeIndex
from .align.engine import ReadAligner
from .io.fastq import read_pairs_indexed
from .io.sam import sam_header, write_read_sam
from .io.sj import SJCollector
from .stats import RunStats


def _not_ported(P: Parameters):
    """options outside this port's slice -> the option names"""
    checks = [
        ("--outSAMtype BAM", P.outBAMunsorted or P.outBAMcoord),
        ("--quantMode", P.quantModeGeneCounts or P.quantModeTrSAM),
        ("--soloType", P.soloTypeYes),
        ("--chimSegmentMin", P.chimSegmentMin > 0),
        ("--twopassMode", P.twopassYes),
        ("--sjdbGTFfile / --sjdbFileChrStartEnd at mapping time",
         P.sjdbGTFfile != "-" or P.sjdbFileChrStartEnd[0] != "-"),
        ("--varVCFfile", P.varVCFfile != "-"),
        ("--genomeTransformOutput", P.transformOutYes),
        ("--peOverlapNbasesMin", P.peOverlapNbasesMin > 0),
        ("--tpuShardedIndex", bool(getattr(P, "tpuShardedIndex", 0))),
        ("--tpuLongReads", P.longReads),
    ]
    return [name for name, on in checks if on]


def align_reads(P: Parameters, gi: Optional[GenomeIndex] = None,
                use_device=None, device=None) -> RunStats:
    """align P.readFilesIn against the index; the seed search runs on
    `device` (default cuda) unless use_device is False (or --tpuUseDevice 0),
    which takes the per-read host oracle"""
    bad = _not_ported(P)
    if bad:
        raise SystemExit("EXITING: option(s) not yet ported to star_tpu_torch: "
                         + ", ".join(bad))
    if gi is None:
        gi = GenomeIndex.load(P.genomeDir)
    P.trInfoDir = P.genomeDir
    return _run_mapping(P, gi, use_device, device)


def _run_mapping(P: Parameters, gi: GenomeIndex, use_device=None,
                 device=None) -> RunStats:
    prefix = P.outFileNamePrefix
    if os.path.dirname(prefix):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)

    stats = RunStats()
    stats.time_start_map = time.time()
    P._transform_type = getattr(gi, "transform_type", 0)

    sj = SJCollector(P, gi)     # final SJ.out.tab records
    sj1 = SJCollector(P, gi)    # BySJout stage-1 records (all reads)
    # SAM text streams to disk as reads finish (bounded memory; the
    # reference's mutex-serialized SAM flush, ReadAlignChunk_processChunks)
    sam_on = (P.outSAMbool and P.outSAMtype[0] != "None"
              and P.outSAMmode != "None")
    sam_lines = _SamSink(prefix + "Aligned.out.sam" if sam_on else None,
                         sam_header(gi, P) if sam_on else "")
    log_out = _LogOut(prefix + "Log.out", P)
    stats.open_progress(prefix + "Log.progress.out")
    log_out.line("started mapping")

    if use_device is None:
        use_device = bool(P.tpuUseDevice)

    by_sjout = P.outFilterBySJoutStage == 1
    held = []

    unmapped_streams = None
    if P.outReadsUnmapped == "Fastx":
        unmapped_streams = [open(prefix + f"Unmapped.out.mate{i+1}", "w")
                            for i in range(P.readNmates)]

    def emit(res):
        if res.unmap_type < 0:
            sj.add_read(res.transcripts, res.n_tr)
            stats.add_mapped(res)
        write_read_sam(res, gi, P, sam_lines)
        if res.unmap_type >= 0:
            stats.add_unmapped(res)
            if unmapped_streams is not None:
                # reference format: "@name <mate>:<filter>: <extra>[ <m0><m1>]"
                mm = getattr(res, "mate_mapped", [False, False])
                suffix = (f" {int(mm[0])}{int(mm[1])}" if len(res.seqs) > 1 else "")
                for im in range(len(res.seqs)):
                    unmapped_streams[im].write(
                        f"@{res.name} {im}:N: {suffix}\n{res.seqs[im]}\n+\n{res.quals[im]}\n")

    for res in _align_all(P, gi, stats, use_device, device):
        if by_sjout:
            # recordSJ1 gate: the reference returns before recording when
            # unmapType>0 (ReadAlign_outputAlignments.cpp:94-96) — over-limit
            # multimappers (unmapType==3) contribute no stage-1 junctions
            if res.unmap_type <= 0:
                sj1.add_read(res.transcripts, res.n_tr)
            if res.unmap_type <= 0 and _has_novel_junction(res):
                stats.read_n -= 1
                stats.read_bases -= sum(len(s) for s in res.seqs)
                held.append((res.name, res.seqs, res.quals,
                             res.read_file_type,
                             getattr(res, "i_read_all", 0),
                             getattr(res, "read_file_index", 0)))
                continue
        emit(res)

    if by_sjout and held:
        # stage 2: restrict stitching to the filtered novel junction set
        novel = [(r[0], r[0] + r[1] - 1) for r in sj1.collapse_and_filter() if r[4] == 0]
        import numpy as np
        starts = np.array([x[0] for x in novel], dtype=np.int64)
        ends = np.array([x[1] for x in novel], dtype=np.int64)
        P2 = P.clone()
        P2.outFilterBySJoutStage = 2
        aligner = ReadAligner(gi, P2)
        aligner.sj_novel = (starts, ends)
        for name, seqs, quals, ftype, iread, ifile in held:
            res = aligner.align_read(name, seqs, quals)
            res.read_file_type = ftype
            res.i_read_all = iread
            res.read_file_index = ifile
            stats.add_read(res)
            emit(res)
        P.outFilterBySJoutStage = 2  # final SJ output skips distance filter

    if unmapped_streams:
        for s in unmapped_streams:
            s.close()

    stats.time_end_map = time.time()
    stats.close_progress()
    log_out.line("finished mapping")

    sam_lines.close()
    if P.outSJtype == "Standard":
        sj.write(prefix + "SJ.out.tab")
    with open(prefix + "Log.final.out", "w") as f:
        f.write(stats.report_final())
    log_out.line("finished successfully")
    log_out.close()
    return stats


class _SamSink:
    """streams SAM lines to disk as they are emitted (bounded memory;
    reference: per-chunk SAM buffers flushed under mutexOutSAM)."""

    def __init__(self, path, header: str):
        self.f = open(path, "w") if path else None
        if self.f is not None and header:
            self.f.write(header)

    def append(self, line: str):
        if self.f is not None and line:
            self.f.write(line + "\n")

    def close(self):
        if self.f is not None:
            self.f.close()
            self.f = None


def _fmt_par(v):
    if isinstance(v, (list, tuple)):
        return "   ".join(str(x) for x in v)
    return str(v)


class _LogOut:
    """main run log (reference: Log.out, InOutStreams.h logMain)"""

    def __init__(self, path: str, P):
        try:
            self.f = open(path, "w")
        except OSError:
            self.f = None
            return
        from . import __version__
        from .params import DEFS_BY_NAME
        w = self.f.write
        w(f"STAR version={__version__} (star-tpu-torch)\n")
        w("##### Command Line:\n" + " ".join(sys.argv) + "\n")
        user = [n for n in getattr(P, "_user_set", []) if n in DEFS_BY_NAME]
        w("###### All USER parameters from Command Line:\n")
        for n in user:
            w(f"{n:<30}{_fmt_par(getattr(P, n))}     ~RE-DEFINED\n")
        w("##### Finished reading parameters from all sources\n\n")
        w("##### Final user re-defined parameters-----------------:\n")
        for n in user:
            w(f"{n:<34}{_fmt_par(getattr(P, n))}\n")
        w("\n##### Final parameters after user input--------------------------------:\n")
        for n in DEFS_BY_NAME:
            try:
                w(f"{n:<34}{_fmt_par(getattr(P, n))}\n")
            except Exception:
                pass
        w("-------------------------------\n")
        w("##### Final effective command line:\n")
        w(" ".join([sys.argv[0] if sys.argv else "star-tpu-torch"]
                   + [f"--{n} {_fmt_par(getattr(P, n))}" for n in user]) + "\n")
        w("----------------------------------------\n")
        self.f.flush()

    def line(self, msg: str):
        if self.f is not None:
            self.f.write(time.strftime("%b %d %H:%M:%S") + " ..... " + msg + "\n")
            self.f.flush()

    def close(self):
        if self.f is not None:
            self.f.close()
            self.f = None


def _has_novel_junction(res) -> bool:
    for tr in res.transcripts:
        for iex in range(tr.nExons - 1):
            if tr.canonSJ[iex] >= 0 and tr.sjAnnot[iex] == 0:
                return True
    return False


def _align_all(P: Parameters, gi: GenomeIndex, stats: RunStats,
               use_device: bool, device=None):
    reader_idx = read_pairs_indexed(P.readFilesIn[:max(P.readNmates, 1)],
                                    P.readFilesCommand,
                                    sam_mates=P.samInputNmates)
    if use_device:
        from .ops.pipeline import DeviceAligner
        aligner = DeviceAligner(gi, P, device=device)
        file_idx = []

        def plain():
            for name, seqs, quals, ftype, ifile, extra in reader_idx:
                file_idx.append((ifile, extra))
                yield name, seqs, quals, ftype
        # align_stream yields in input order (reference-order replay)
        for k, res in enumerate(aligner.align_stream(plain(), stats)):
            res.read_file_index, res.name_extra = file_idx[k]
            yield res
    else:
        aligner = ReadAligner(gi, P)
        n = 0
        for name, seqs, quals, ftype, ifile, extra in reader_idx:
            if P.readMapNumber >= 0 and n >= P.readMapNumber:
                break
            res = aligner.align_read(name, seqs, quals)
            res.read_file_type = ftype
            res.read_file_index = ifile
            res.name_extra = extra
            res.i_read_all = n
            stats.add_read(res)
            n += 1
            yield res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    P = Parameters(argv)
    if P.runMode[0] != "alignReads":
        raise SystemExit(f"EXITING: --runMode {P.runMode[0]} is not yet "
                         "ported to star_tpu_torch")
    else:
        align_reads(P)


if __name__ == "__main__":
    main()
