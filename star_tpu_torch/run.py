"""Run drivers: genomeGenerate, alignReads, liftOver and
inputAlignmentsFromBAM.

The port's run surface (reference: source/STAR.cpp dispatch): index
generation with or without annotations, mapping-time sjdb insertion, two-pass
mode (pass-1 junction discovery + re-insertion, reference:
twoPassRunPass1.cpp), outFilterType BySJout, SAM / BAM (unsorted and
coordinate-sorted) / SJ / log outputs, unmapped-read FASTX, GeneCounts and
TranscriptomeSAM quantification, bedGraph signal, BAM duplicate removal and
GTF liftOver, single- and paired-end.  The device path runs the seed search
and the stitch engine on the GPU (ops/pipeline.py DeviceAligner); the host
runs the rest.  Options whose stages are not ported yet stop the run with a
message that names them.

With pipeline.TIMING on, the host stages of this module add to
pipeline.TIMERS: sjdb_insert (junction collection, insertion and
--sjdbInsertSave), pristine (the re-sort of an index without its junction
region before re-insertion), bam_encode, quant (GeneCounts and
TranscriptomeSAM per read), bam_finish (the coordinate sort and the BAM
writes) and signal.
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
from .ops.pipeline import _tick
from .stats import RunStats


def _not_ported(P: Parameters):
    """options outside this port's slices -> the option names"""
    checks = [
        ("--soloType", P.soloTypeYes),
        ("--chimSegmentMin", P.chimSegmentMin > 0),
        ("--varVCFfile", P.varVCFfile != "-"),
        ("--genomeTransformOutput", P.transformOutYes),
        ("--peOverlapNbasesMin", P.peOverlapNbasesMin > 0),
        ("--tpuShardedIndex", bool(getattr(P, "tpuShardedIndex", 0))),
        ("--tpuLongReads", P.longReads),
    ]
    return [name for name, on in checks if on]


def _refuse(names):
    raise SystemExit("EXITING: option(s) not yet ported to star_tpu_torch: "
                     + ", ".join(names))


def genome_generate(P: Parameters):
    if P.transformTypeN > 0:
        _refuse(["--genomeTransformVCF / --genomeTransformType"])
    gi = GenomeIndex.generate(
        P.genomeFastaFiles, chr_bin_nbits=P.genomeChrBinNbits,
        sa_index_nbases=P.genomeSAindexNbases, sa_sparse_d=P.genomeSAsparseD)
    if P.sjdbGTFfile != "-" or P.sjdbFileChrStartEnd[0] != "-":
        from .genome.sjdb import insert_junctions_from_annotations
        gi.sjdb_overhang = P.sjdbOverhang
        gi = insert_junctions_from_annotations(gi, P, out_dir=P.genomeDir)
    gi.save(P.genomeDir)
    return gi


def _collect_sjdb_loci(gi, P, pass1_sj_file=None):
    """junction list for (re-)insertion: saved genome sjdb (prio 30) +
    mapping-time files (10) / GTF (20) + pass-1 discoveries (0)."""
    from .genome.gtf import SjdbLoci, parse_gtf, transcript_gene_sj
    from .genome.sjdb import load_sjdb_file
    sjdb = SjdbLoci()
    if gi.sjdb_n > 0:
        # reconstruct saved junction list from tables
        strand_char = ".+-"
        for i in range(gi.sjdb_n):
            s, e = int(gi.sjdb_start[i]), int(gi.sjdb_end[i])
            sh = int(gi.sjdb_shift_left[i]) if gi.sjdb_motif[i] == 0 else 0
            ci = int(gi.chr_bin[s >> gi.chr_bin_nbits])
            cs = int(gi.chr_start[ci])
            sjdb.chr.append(gi.chr_name[ci])
            sjdb.start.append(s - cs + 1 + sh)
            sjdb.end.append(e - cs + 1 + sh)
            sjdb.str_.append(strand_char[gi.sjdb_strand[i]])
            sjdb.gene.append(set())
            sjdb.priority.append(30)
    if P.sjdbFileChrStartEnd[0] != "-":
        for path in P.sjdbFileChrStartEnd:
            load_sjdb_file(path, sjdb, priority=10)
    if P.sjdbGTFfile != "-":
        ann = parse_gtf(P.sjdbGTFfile, gi, P)
        transcript_gene_sj(ann, gi, _tmp_dir(P), sjdb)
    if pass1_sj_file is not None:
        load_sjdb_file(pass1_sj_file, sjdb, priority=0)
    return sjdb


def _tmp_dir(P):
    d = P.outFileNamePrefix + "_STARtmp"
    os.makedirs(d, exist_ok=True)
    return d


def _pristine(gi):
    """genome index restricted to the real chromosomes (drop sj region)"""
    if gi.sjdb_n == 0:
        return gi
    import numpy as np
    from .genome.fasta import build_t2
    from .genome.generate import sort_suffixes, build_sai
    n_real = int(gi.chr_start[-1])
    G = gi.G[:n_real].copy()
    t2 = build_t2(G)
    sa = sort_suffixes(t2)
    sai = build_sai(t2, sa, gi.sa_index_nbases)
    return GenomeIndex(
        G=G, t2=t2, sa=sa, sai_level_start=sai["level_start"],
        sai_val=sai["val"], sai_absent=sai["absent"], sai_nbit=sai["nbit"],
        chr_name=list(gi.chr_name), chr_start=gi.chr_start.copy(),
        chr_length=gi.chr_length.copy(), chr_bin_nbits=gi.chr_bin_nbits,
        sa_index_nbases=gi.sa_index_nbases, sa_sparse_d=gi.sa_sparse_d,
        sjdb_overhang=gi.sjdb_overhang)


def align_reads(P: Parameters, gi: Optional[GenomeIndex] = None,
                use_device=None, device=None) -> RunStats:
    """align P.readFilesIn against the index; the seed search and the stitch
    engine run on `device` (default cuda) unless use_device is False (or
    --tpuUseDevice 0), which takes the per-read host oracle.  Each pass of a
    two-pass run maps on the same device, against its own index."""
    bad = _not_ported(P)
    if bad:
        _refuse(bad)
    if gi is None:
        gi = GenomeIndex.load(P.genomeDir)
    P.trInfoDir = P.genomeDir

    # mapping-time sjdb insertion (GTF / junction files given at align time)
    if P.sjdbGTFfile != "-" or P.sjdbFileChrStartEnd[0] != "-":
        from .genome.sjdb import insert_junctions
        with _tick("sjdb_insert"):
            sjdb = _collect_sjdb_loci(gi, P)
        with _tick("pristine"):
            base = _pristine(gi)
        with _tick("sjdb_insert"):
            base.sjdb_overhang = (P.sjdbOverhang if gi.sjdb_n == 0
                                  else gi.sjdb_overhang)
            gi = insert_junctions(base, sjdb, P, out_dir=_tmp_dir(P))
            if P.sjdbGTFfile != "-":
                P.trInfoDir = _tmp_dir(P)
            _sjdb_insert_save(gi, P)

    # two-pass: pass 1 + junction re-insertion
    if P.twopassYes:
        pass1_dir = P.outFileNamePrefix + "_STARpass1/"
        os.makedirs(pass1_dir, exist_ok=True)
        P1 = P.clone(outSAMtype=["None"], outSAMunmapped=["None"],
                     outReadsUnmapped="None", outFileNamePrefix=pass1_dir,
                     twopassMode="None", outFilterType="Normal",
                     quantMode=["-"], genomeTransformOutput=["None"],
                     readMapNumber=(P.twopass1readsN
                                    if P.twopass1readsN >= 0 else P.readMapNumber))
        _run_mapping(P1, gi, use_device, device)
        # pass 1's device tables go before pass 2 uploads its own index
        gi._device_cache.clear()
        from .genome.sjdb import insert_junctions
        with _tick("sjdb_insert"):
            sjdb = _collect_sjdb_loci(gi, P,
                                      pass1_sj_file=pass1_dir + "SJ.out.tab")
        with _tick("pristine"):
            base = _pristine(gi)
        with _tick("sjdb_insert"):
            base.sjdb_overhang = (P.sjdbOverhang if base.sjdb_overhang == 0
                                  else base.sjdb_overhang)
            if base.sjdb_overhang == 0:
                base.sjdb_overhang = 100
            gi = insert_junctions(base, sjdb, P, out_dir=_tmp_dir(P))
            _sjdb_insert_save(gi, P)

    return _run_mapping(P, gi, use_device, device)


def _sjdb_insert_save(gi, P):
    """--sjdbInsertSave All: persist the junction-augmented index under
    <prefix>_STARgenome/ so later runs skip re-insertion (reference:
    sjdbInsertJunctions.cpp:70-98 saving into P.sjdbInsert.outDir)"""
    if getattr(P, "sjdbInsertSave", "Basic") == "All":
        out = P.outFileNamePrefix + "_STARgenome"
        gi.save(out)


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

    bam = None
    if P.outBAMunsorted or P.outBAMcoord:
        from .io.bam import BamCollector
        bam = BamCollector(gi, P, prefix)

    gene_counts = None
    tr_sam = None
    trm = None
    if P.quantModeGeneCounts or P.quantModeTrSAM:
        from .quant.transcriptome import Transcriptome, GeneCounts
        trm = Transcriptome.load(getattr(P, "trInfoDir", P.genomeDir))
        if P.quantModeGeneCounts:
            gene_counts = GeneCounts(trm)
    if P.quantModeTrSAM:
        from .quant.trsam import TrGenomeShim, quant_transcriptome
        from .io.bam import BgzfWriter, bam_header_bytes, encode_mapped
        from .utils.rng import MT19937
        tr_shim = TrGenomeShim(trm)
        tr_bam = BgzfWriter(prefix + "Aligned.toTranscriptome.out.bam")
        tr_bam.write(bam_header_bytes(None, P, chr_names=tr_shim.chr_name,
                                      chr_lens=[int(x) for x in tr_shim.chr_length]))
        tr_rng = MT19937(P.runRNGseed * 1)
        tr_sam = (quant_transcriptome, encode_mapped, tr_shim, tr_bam, tr_rng)

    if use_device is None:
        use_device = bool(P.tpuUseDevice)

    by_sjout = P.outFilterBySJoutStage == 1
    held = []

    unmapped_streams = None
    if P.outReadsUnmapped == "Fastx":
        unmapped_streams = [open(prefix + f"Unmapped.out.mate{i+1}", "w")
                            for i in range(P.readNmates)]

    def quant(res):
        if gene_counts is not None:
            gene_counts.add_read(res.transcripts, res.n_tr)
        if tr_sam is not None:
            quantt, enc, shim, w, rng = tr_sam
            mm_max = min(P.outFilterMismatchNmax,
                         int(P.outFilterMismatchNoverReadLmax
                             * (res.read_length[0] + res.read_length[1])))
            al_t = quantt(res, trm, gi, P, rng, mm_max)
            for i_t, at in enumerate(al_t):
                at.roStr = 0
                for (r, _, _, _) in enc(at, res, len(al_t), i_t, shim, P,
                                        attrs_order=["NH", "HI"]):
                    w.write(r)

    def emit(res):
        if res.unmap_type < 0:
            sj.add_read(res.transcripts, res.n_tr)
            stats.add_mapped(res)
            if trm is not None:
                with _tick("quant"):
                    quant(res)
        if bam is not None:
            with _tick("bam_encode"):
                bam.add_read(res)
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
    if tr_sam is not None:
        tr_sam[3].close()
    if bam is not None:
        with _tick("bam_finish"):
            bam.finish()
        if P.outWigType[0] != "None" and P.outBAMcoord:
            from .io.signal import signal_from_bam
            with _tick("signal"):
                signal_from_bam(prefix + "Aligned.sortedByCoord.out.bam",
                                prefix + "Signal", P)
    if P.outSJtype == "Standard":
        sj.write(prefix + "SJ.out.tab")
    if gene_counts is not None:
        n_unmapped = (stats.unmapped_mm + stats.unmapped_short
                      + stats.unmapped_other + stats.unmapped_multi)
        gene_counts.write(prefix + "ReadsPerGene.out.tab", n_unmapped)
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
    if "genomeGenerate" in P.runMode:
        genome_generate(P)
    elif P.runMode[0] == "liftOver":
        from .io.liftover import lift_over_main
        lift_over_main(P)
    elif P.runMode[0] == "soloCellFiltering":
        _refuse(["--runMode soloCellFiltering"])
    elif "inputAlignmentsFromBAM" in P.runMode:
        if P.outWigType[0] != "None":
            from .io.signal import signal_from_bam
            signal_from_bam(P.inputBAMfile, P.outFileNamePrefix + "Signal", P)
        elif P.bamRemoveDuplicatesType != "-":
            from .io.dedup import bam_remove_duplicates
            bam_remove_duplicates(P.inputBAMfile,
                                  P.outFileNamePrefix + "Processed.out.bam", P)
    else:
        align_reads(P)


if __name__ == "__main__":
    main()
