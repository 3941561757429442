"""Run drivers: genomeGenerate, alignReads, liftOver,
inputAlignmentsFromBAM and soloCellFiltering.

The port's run surface (reference: source/STAR.cpp dispatch): index
generation with or without annotations, mapping-time sjdb insertion, two-pass
mode (pass-1 junction discovery + re-insertion, reference:
twoPassRunPass1.cpp), outFilterType BySJout, SAM / BAM (unsorted and
coordinate-sorted) / SJ / log outputs, unmapped-read FASTX, GeneCounts and
TranscriptomeSAM quantification, bedGraph signal, BAM duplicate removal and
GTF liftOver, chimeric detection (Chimeric.out.junction, SeparateSAMold,
WithinBAM), the PE mate-overlap merge, long reads, SNP tags and WASP, and the
STARconsensus genome transform, single- and paired-end, and STARsolo
(CB_UMI_Simple, CB_UMI_Complex, SmartSeq, CB_samTagOut; solo/).  The device
path runs the seed search and the stitch engine on the GPU (ops/pipeline.py
DeviceAligner), on one device or on the suffix array row-sharded over a
mesh of shards (--tpuShardedIndex 1, parallel/mesh.py); the host runs the
rest.

With pipeline.TIMING on, the host stages of this module add to
pipeline.TIMERS (and pipeline.SPANS): sjdb_insert (junction collection,
insertion and --sjdbInsertSave), pristine (the re-sort of an index without
its junction region before re-insertion), job_open (the index load where
align_reads is given none; the outputs, Log.out, the BAM collector,
Transcriptome.load and Solo(...) with its whitelist, up to the first read),
emit (each read's output outside the keys below: chimeric detection,
SJ.out.tab records, stats, SAM and unmapped FASTX), bam_encode, quant
(GeneCounts and TranscriptomeSAM per read) with trsam inside it (the
transcriptome bans, soft-clip extension and projection, without the BAM
records), bysj_stage2 (BySJout's junction filter and the held reads mapped
again on the host, with their output), solo_count (the barcode match
and the per-read STARsolo feature record, or the CB_samTagOut barcode
match), solo_process (STARsolo counting, cell filtering and the Solo.out
files; solo/solo.py splits it), bam_finish (the coordinate sort and the BAM
writes), signal and job_close (the streams closed after the last read;
SJ.out.tab, ReadsPerGene, the chimeric files and Log.final.out).
align_reads is one job (pipeline._job): its seconds outside every
top-level span go to TIMERS["untimed"].  It counts into pipeline.COUNTS
the reads BySJout holds for stage 2 (bysj_held) and the transcriptome
records written (trsam_records).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

from .params import Parameters
from .genome.index import GenomeIndex
from .align.engine import ReadAligner
from .io.fastq import read_pairs, read_pairs_indexed
from .io.sam import sam_header, write_read_sam
from .io.sj import SJCollector
from .ops.pipeline import _count, _job, _tick
from .stats import RunStats


def genome_generate(P: Parameters):
    if P.transformTypeN > 0:
        return _genome_generate_transform(P)
    gi = GenomeIndex.generate(
        P.genomeFastaFiles, chr_bin_nbits=P.genomeChrBinNbits,
        sa_index_nbases=P.genomeSAindexNbases, sa_sparse_d=P.genomeSAsparseD)
    if P.sjdbGTFfile != "-" or P.sjdbFileChrStartEnd[0] != "-":
        from .genome.sjdb import insert_junctions_from_annotations
        gi.sjdb_overhang = P.sjdbOverhang
        gi = insert_junctions_from_annotations(gi, P, out_dir=P.genomeDir)
    gi.save(P.genomeDir)
    return gi


def _genome_generate_transform(P: Parameters):
    """STARconsensus: apply the VCF to the genome, generate the transformed
    index (+ conversion blocks), then a full index of the original genome in
    OriginalGenome/ (reference: STAR.cpp:94-102, Genome_transformGenome.cpp)"""
    import numpy as np
    from types import SimpleNamespace
    from .genome.fasta import scan_fasta_files, build_t2
    from .genome.generate import sort_suffixes, build_sai
    from .genome.transform import (load_transform_vcf, transform_chr_len_start,
                                   transform_g_and_blocks, transform_exon_loci,
                                   write_blocks_tsv)
    from .genome.gtf import parse_gtf, Annotation

    ttype = P.transformTypeN
    bin_nb = 1 << P.genomeChrBinNbits
    G0, names0, chr_start0, chr_len0 = scan_fasta_files(
        P.genomeFastaFiles, bin_nb)

    ann = None
    if P.sjdbGTFfile != "-":
        shell = SimpleNamespace(chr_name=names0, chr_start=chr_start0,
                                chr_length=chr_len0)
        ann = parse_gtf(P.sjdbGTFfile, shell, P)

    vcf_h = load_transform_vcf(P.genomeTransformVCF, names0, ttype)
    per_h = []
    for ih in range(ttype):
        per_h.append(transform_chr_len_start(
            vcf_h[ih], names0, chr_start0, chr_len0, bin_nb))

    if ttype == 1:
        filt, chr_start1, chr_len1 = per_h[0]
        Gnew = np.full(chr_start1[-1], 5, dtype=np.int8)
        blocks = []
        transform_g_and_blocks(filt, names0, chr_start0, chr_len0,
                               chr_start1, G0, Gnew, blocks)
        if ann is not None:
            ann.exon_loci = transform_exon_loci(ann.exon_loci, blocks)
        names1 = list(names0)
        starts1 = np.array(chr_start1, dtype=np.int64)
        lens1 = np.array(chr_len1, dtype=np.int64)
    else:
        (f0, cs0_, cl0_), (f1, cs1_, cl1_) = per_h
        off = cs0_[-1]
        cs1_off = [c + off for c in cs1_]
        Gnew = np.full(cs1_off[-1], 5, dtype=np.int8)
        blocks = []
        transform_g_and_blocks(f0, names0, chr_start0, chr_len0,
                               cs0_, G0, Gnew, blocks)
        blocks1 = []
        transform_g_and_blocks(f1, names0, chr_start0, chr_len0,
                               cs1_off, G0, Gnew, blocks1)
        if ann is not None:
            nTr, nGe = len(ann.transcript_id), len(ann.gene_id)
            ex0 = transform_exon_loci(ann.exon_loci, blocks)
            ex1 = transform_exon_loci(ann.exon_loci, blocks1)
            if len(ex1):
                ex1[:, 0] += nTr
                ex1[:, 3] += nGe
            ann = Annotation(
                transcript_id=[t + "_h1" for t in ann.transcript_id]
                + [t + "_h2" for t in ann.transcript_id],
                transcript_strand=ann.transcript_strand * 2,
                gene_id=[g + "_h1" for g in ann.gene_id]
                + [g + "_h2" for g in ann.gene_id],
                gene_attr=ann.gene_attr * 2,
                exon_loci=np.concatenate([ex0, ex1], axis=0))
        blocks = blocks + blocks1
        names1 = [n + "_h1" for n in names0] + [n + "_h2" for n in names0]
        starts1 = np.array(cs0_[:-1] + cs1_off, dtype=np.int64)
        lens1 = np.array(cl0_ + cl1_, dtype=np.int64)

    os.makedirs(P.genomeDir, exist_ok=True)
    write_blocks_tsv(os.path.join(P.genomeDir, "transformGenomeBlocks.tsv"),
                     blocks)

    t2 = build_t2(Gnew)
    sai = build_sai(t2, sa := sort_suffixes(t2), P.genomeSAindexNbases)
    gi = GenomeIndex(
        G=Gnew, t2=t2, sa=sa,
        sai_level_start=sai["level_start"], sai_val=sai["val"],
        sai_absent=sai["absent"], sai_nbit=sai["nbit"],
        chr_name=names1, chr_start=starts1, chr_length=lens1,
        chr_bin_nbits=P.genomeChrBinNbits,
        sa_index_nbases=P.genomeSAindexNbases, sa_sparse_d=P.genomeSAsparseD)
    if P.sjdbGTFfile != "-" or P.sjdbFileChrStartEnd[0] != "-":
        from .genome.sjdb import insert_junctions_from_annotations
        gi.sjdb_overhang = P.sjdbOverhang
        gi = insert_junctions_from_annotations(gi, P, out_dir=P.genomeDir,
                                               ann=ann)
    gi.transform_type = ttype
    gi.save(P.genomeDir)

    # full original-genome index alongside (reference STAR.cpp:94-102)
    P2 = P.clone(genomeTransformType="None", genomeTransformVCF="-",
                 genomeDir=os.path.join(P.genomeDir, "OriginalGenome"))
    P2.transformTypeN = 0
    genome_generate(P2)
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
                use_device=None, device=None, mesh=None) -> RunStats:
    """align P.readFilesIn against the index; the seed search and the stitch
    engine run on `device` (default cuda) unless use_device is False (or
    --tpuUseDevice 0), which takes the per-read host oracle.  Each pass of a
    two-pass run maps on the same device, against its own index.  With
    --tpuShardedIndex 1 the seed search runs on the index row-sharded over
    `mesh` (parallel/mesh.py make_mesh; default one shard per visible card,
    or one on `device` where the caller names it) and the gene counts merge
    over its dp rows."""
    with _job():
        return _align_reads(P, gi, use_device, device, mesh)


def _align_reads(P, gi, use_device, device, mesh):
    if mesh is not None and not getattr(P, "tpuShardedIndex", 0):
        raise ValueError("align_reads: a mesh needs --tpuShardedIndex 1")
    if gi is None:
        with _tick("job_open"):
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
        _run_mapping(P1, gi, use_device, device, mesh)
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

    # variation (VCF SNVs) for vA/vG tags and WASP (STAR.cpp:139-142)
    if P.varVCFfile != "-":
        from .align.variation import Variation
        gi.var = Variation(
            P, gi.chr_start, {n: i for i, n in enumerate(gi.chr_name)})

    return _run_mapping(P, gi, use_device, device, mesh)


def _sjdb_insert_save(gi, P):
    """--sjdbInsertSave All: persist the junction-augmented index under
    <prefix>_STARgenome/ so later runs skip re-insertion (reference:
    sjdbInsertJunctions.cpp:70-98 saving into P.sjdbInsert.outDir)"""
    if getattr(P, "sjdbInsertSave", "Basic") == "All":
        out = P.outFileNamePrefix + "_STARgenome"
        gi.save(out)


def _run_mapping(P: Parameters, gi: GenomeIndex, use_device=None,
                 device=None, mesh=None) -> RunStats:
    # job_open runs from here to the first read pulled; an exception on the
    # way leaves it open, and the job's scope drops it
    opening = _tick("job_open")
    opening.__enter__()
    prefix = P.outFileNamePrefix
    if os.path.dirname(prefix):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)

    stats = RunStats()
    stats.time_start_map = time.time()

    # STARconsensus: load the original genome + conversion blocks; all
    # coordinate-bearing outputs switch to it (reference: STAR.cpp:138-142,
    # Genome_genomeLoad.cpp:444-462)
    gen_out = None
    gi_o = gi
    if P.transformOutYes:
        from .genome.transform import GenomeOut
        if getattr(gi, "transform_type", 0) == 0:
            raise SystemExit(
                "EXITING because of FATAL INPUT ERROR: outTransformOutput is "
                "set, but the genome was generated without transformation\n"
                "SOLUTION: use the default --genomeTransformOutput None, or "
                "re-generate the genome with transformation options.")
        gen_out = GenomeOut.load(P.genomeDir, gi.transform_type,
                                 len(gi.chr_name))
        gi_o = gen_out.gi
    P._transform_type = getattr(gi, "transform_type", 0)

    sj = SJCollector(P, gi_o)   # final SJ.out.tab records
    sj1 = SJCollector(P, gi)    # BySJout stage-1 records (all reads)
    # SAM text streams to disk as reads finish (bounded memory; the
    # reference's mutex-serialized SAM flush, ReadAlignChunk_processChunks)
    sam_on = (P.outSAMbool and P.outSAMtype[0] != "None"
              and P.outSAMmode != "None")
    sam_lines = _SamSink(prefix + "Aligned.out.sam" if sam_on else None,
                         sam_header(gi_o, P) if sam_on else "")
    log_out = _LogOut(prefix + "Log.out", P)
    stats.open_progress(prefix + "Log.progress.out")
    log_out.line("started mapping")

    if use_device is None:
        use_device = bool(P.tpuUseDevice)
    sharded = bool(getattr(P, "tpuShardedIndex", 0))
    if sharded and gi.sa_sparse_d > 1 and use_device:
        # as in star_tpu (run.py:320-323), whose sharded seed round has no
        # phase-offset probes: a sparse suffix array maps on the host
        use_device = False
        log_out.line("--tpuShardedIndex: a sparse suffix array "
                     "(--genomeSAsparseD > 1) maps on the host, not on the "
                     "sharded index")
    if P.longReads and use_device:
        # STARlong: reads up to 500 kb would force huge static probe shapes;
        # the host seed loop + seed-chain DP handles them (align/stitch.py
        # stitch_window_seeds), as in the JAX package
        use_device = False
        log_out.line("--tpuLongReads: long reads map on the host (seed-chain "
                     "DP, align/stitch.py stitch_window_seeds), not on the "
                     "device")
    if not use_device:
        mesh = None             # the host searches no index shards
    elif sharded and mesh is None:
        from .parallel.mesh import make_mesh
        mesh = make_mesh(None if device is None else [device])

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
            if mesh is not None:
                from .quant.transcriptome import ShardedGeneCounts
                gene_counts = ShardedGeneCounts(trm, mesh)
            else:
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


    solo = None
    cb_tag_bc = None
    if P.soloTypeYes and P.soloType[0] == "CB_samTagOut":
        # barcode extraction + corrected-CB SAM tag, no counting
        # (reference Solo.cpp:13, SoloReadBarcode_getCBandUMI.cpp:311-328)
        from .solo.solo import SoloBarcodes
        if P.soloCBmatchWLtype not in ("Exact", "1MM"):
            raise SystemExit(
                "EXITING because of fatal PARAMETERS error: --soloCBmatchWLtype "
                f"{P.soloCBmatchWLtype} does not work with --soloType "
                "CB_samTagOut\nSOLUTION: use allowed option: use "
                "--soloCBmatchWLtype Exact (exact matches only) OR 1MM (one "
                "match with 1 mismatched base)")
        cb_tag_bc = SoloBarcodes(P)
    if P.soloTypeYes and P.soloType[0] in ("CB_UMI_Simple", "CB_UMI_Complex",
                                           "SmartSeq"):
        from .quant.transcriptome import Transcriptome
        from .ops.fetch import resolve_device
        from .solo.solo import Solo
        trm_solo = Transcriptome.load(getattr(P, "trInfoDir", P.genomeDir))
        # the job's device: the card in a device job, else the host
        solo = Solo(gi, P, trm_solo,
                    resolve_device(device) if use_device else "cpu")
        P._solo_trm = trm_solo

    chim_stream = None
    chim_lines = []
    chim_sam_lines = []
    if P.chimSegmentMin > 0 and P.outFilterBySJoutStage <= 1:
        from .align.chimeric import (detect_chimeric_old, align_score,
                                     junction_line)
        chim_stream = (detect_chimeric_old, align_score, junction_line)

    by_sjout = P.outFilterBySJoutStage == 1
    held = []

    unmapped_streams = None
    if P.outReadsUnmapped == "Fastx":
        unmapped_streams = [open(prefix + f"Unmapped.out.mate{i+1}", "w")
                            for i in range(P.readNmates)]

    def quant(res, q_trs):
        if gene_counts is not None:
            gene_counts.add_read(*(q_trs or (res.transcripts, res.n_tr)))
        if tr_sam is not None:
            quantt, enc, shim, w, rng = tr_sam
            mm_max = min(P.outFilterMismatchNmax,
                         int(P.outFilterMismatchNoverReadLmax
                             * (res.read_length[0] + res.read_length[1])))
            with _tick("trsam"):
                al_t = quantt(res, trm, gi, P, rng, mm_max)
            for i_t, at in enumerate(al_t):
                at.roStr = 0
                for (r, _, _, _) in enc(at, res, len(al_t), i_t, shim, P,
                                        attrs_order=["NH", "HI"]):
                    w.write(r)
                    _count("trsam_records")

    def solo_read(res):
        if solo is not None and getattr(res, "solo_bc", None) is not None:
            solo.add_read(res, res.solo_bc[0], res.solo_bc[1],
                          getattr(res, "i_read_all", 0))
        elif solo is not None and P.soloType[0] == "SmartSeq":
            solo.add_read(res, "", "", getattr(res, "i_read_all", 0))
        elif cb_tag_bc is not None:
            b_seq, b_qual = res.solo_bc
            cb_match, matches, _, parts = cb_tag_bc.get_cb_umi(
                b_seq, b_qual, skip_umi=True)
            res.solo_bar = parts
            if cb_match in (0, 1):
                res.cb_corrected = (cb_tag_bc.wl_str[matches[0][0]]
                                    if cb_tag_bc.wl_yes else parts[0])
            else:
                res.cb_corrected = "-"

    def chimeric(res):
        """chimeric detection and its outputs; whether a chimera was
        recorded"""
        recorded = False
        detect, ascore, jline = chim_stream
        if P.chimMultimapNmax == 0:
            chim = detect(res, res.all_win_tr, bytes(res.read1), gi, P)
            if chim is not None:
                recorded = True
                stats.chimeric_all += 1
                for t in chim.tr:
                    ascore(t, bytes(res.read1), bytes(res.read1rc), gi, P)
                if P.chimOutTypeWithinBAM and bam is not None:
                    from .io.bam import encode_chimeric
                    bam.add_chimeric(
                        encode_chimeric(chim.tr[0], chim.tr[1], res, 0, 1,
                                        True, gi, P),
                        getattr(res, "i_read_all", 0), 0)
                if P.chimOutTypeJunctions:
                    chim_lines.append(jline(chim, res, gi, P))
                if P.chimOutTypeSAMold:
                    chim_sam_lines.extend(
                        _chimeric_sam_old(chim.tr, res, gi, P))
        elif res.tr_best.maxScore <= (res.read_length[0]
                                      + res.read_length[1]
                                      - P.chimNonchimScoreDropMin):
            # multimapping chimeras (chimericDetectionMult)
            from .align.chimeric import (detect_chimeric_mult,
                                         junction_line_mult)
            found = detect_chimeric_mult(
                res, res.all_win_tr, bytes(res.read1),
                bytes(res.read1rc), gi, P)
            if found is not None:
                recs, chim_n, best_i, min_score = found
                recorded = True
                stats.chimeric_all += 1
                best_score = recs[best_i].chimScore
                max_possible = res.read_length[0] + res.read_length[1]
                i_tr = 0
                for i, ch in enumerate(recs):
                    if ch.chimScore < min_score:
                        continue
                    if P.chimOutTypeJunctions:
                        chim_lines.append(junction_line_mult(
                            ch, res, gi, P, chim_n, res.tr_best.maxScore,
                            False, best_score, max_possible))
                    if P.chimOutTypeWithinBAM and bam is not None:
                        from .io.bam import encode_chimeric
                        bam.add_chimeric(
                            encode_chimeric(ch.al1, ch.al2, res, i_tr,
                                            chim_n, i == best_i, gi, P),
                            getattr(res, "i_read_all", 0), i_tr)
                    i_tr += 1
        return recorded

    def emit(res):
        if solo is not None or cb_tag_bc is not None:
            with _tick("solo_count"):
                solo_read(res)
        with _tick("emit"):
            # chimeric detection runs for every read with windows, including
            # reads failing the linear filters (reference: oneRead order)
            if (chim_stream is not None
                    and getattr(res, "read1", None) is not None
                    and chimeric(res) and P.chimOutTypeWithinBAM):
                # the recorded chimera contains the representative portion,
                # so the non-chimeric alignment is not output
                # (oneRead.cpp:99-101)
                return
            q_trs = None
            if gen_out is not None:
                # STARconsensus back-conversion (reference
                # ReadAlign_transformGenome runs for every read with 0 < nTr
                # <= outFilterMultimapNmax; the unmapped-within record then
                # reports the converted best)
                from .genome.transform import read_transform
                read_transform(res, gen_out, P)
                q_trs = ((res.transcripts_out, res.n_tr_out)
                         if P.transformOutQuant
                         else (res.transcripts, res.n_tr))
                stats_set = (res.transcripts_out, res.n_tr_out)
                if P.transformOutSAM:
                    res.transcripts = res.transcripts_out
                    res.n_tr = res.n_tr_out
                    if res.tr_best_out is not None:
                        res.tr_best = res.tr_best_out
            else:
                stats_set = None
            if res.unmap_type < 0:
                sj.add_read(res.transcripts, res.n_tr)
                stats.add_mapped(res, override=stats_set)
        if res.unmap_type < 0 and trm is not None:
            with _tick("quant"):
                quant(res, q_trs)
        if bam is not None:
            with _tick("bam_encode"):
                bam.add_read(res)
        with _tick("emit"):
            write_read_sam(res, gi_o, P, sam_lines)
            if res.unmap_type >= 0:
                stats.add_unmapped(res)
                if unmapped_streams is not None:
                    # reference format:
                    # "@name <mate>:<filter>: <extra>[ <m0><m1>]"
                    mm = getattr(res, "mate_mapped", [False, False])
                    suffix = (f" {int(mm[0])}{int(mm[1])}"
                              if len(res.seqs) > 1 else "")
                    for im in range(len(res.seqs)):
                        unmapped_streams[im].write(
                            f"@{res.name} {im}:N: {suffix}\n{res.seqs[im]}"
                            f"\n+\n{res.quals[im]}\n")

    opening.__exit__(None, None, None)
    for res in _align_all(P, gi, stats, use_device, device, mesh):
        if by_sjout:
            # recordSJ1 gate: the reference returns before recording when
            # unmapType>0 (ReadAlign_outputAlignments.cpp:94-96) — over-limit
            # multimappers (unmapType==3) contribute no stage-1 junctions
            if res.unmap_type <= 0:
                sj1.add_read(res.transcripts, res.n_tr)
            if res.unmap_type <= 0 and _has_novel_junction(res):
                stats.read_n -= 1
                stats.read_bases -= sum(len(s) for s in res.seqs)
                _count("bysj_held")
                held.append((res.name, res.seqs, res.quals,
                             res.read_file_type,
                             getattr(res, "i_read_all", 0),
                             getattr(res, "solo_bc", None),
                             getattr(res, "read_file_index", 0)))
                continue
        emit(res)

    if by_sjout and held:
        # stage 2: restrict stitching to the filtered novel junction set
        with _tick("bysj_stage2"):
            novel = [(r[0], r[0] + r[1] - 1)
                     for r in sj1.collapse_and_filter() if r[4] == 0]
            import numpy as np
            starts = np.array([x[0] for x in novel], dtype=np.int64)
            ends = np.array([x[1] for x in novel], dtype=np.int64)
            P2 = P.clone()
            P2.outFilterBySJoutStage = 2
            aligner = ReadAligner(gi, P2)
            aligner.sj_novel = (starts, ends)
            for name, seqs, quals, ftype, iread, solo_bc, ifile in held:
                res = aligner.align_read(name, seqs, quals)
                res.read_file_type = ftype
                res.i_read_all = iread
                res.solo_bc = solo_bc
                res.read_file_index = ifile
                stats.add_read(res)
                emit(res)
        P.outFilterBySJoutStage = 2  # final SJ output skips distance filter

    with _tick("job_close"):
        if unmapped_streams:
            for s in unmapped_streams:
                s.close()

        stats.time_end_map = time.time()
        stats.close_progress()
        log_out.line("finished mapping")

        sam_lines.close()
        if tr_sam is not None:
            tr_sam[3].close()
    # Solo counting runs before the coordinate sort so CB/UB tags can be
    # injected into sorted records (reference STAR.cpp:255 vs :272)
    solo_tags = None
    if solo is not None:
        with _tick("solo_process"):
            import numpy as np
            sj_rows = sj.collapse_and_filter()
            sj_all = (np.array([r[0] for r in sj_rows], dtype=np.int64),
                      np.array([r[1] for r in sj_rows], dtype=np.int64))
            run_stats = {"readN": stats.read_n,
                         "mappedU": stats.mapped_reads_u,
                         "mappedUM": (stats.mapped_reads_u
                                      + stats.mapped_reads_m)}
            solo.process(prefix + "Solo.out/", run_stats, sj_all)
            if P.outSAMattrCBUB:
                proc = solo.procs[solo.sam_attr_feature]
                solo_tags = (proc.read_info, solo.bc.wl_str, solo.bc.umi_l)
    if bam is not None:
        with _tick("bam_finish"):
            bam.finish(solo_tags)
        if P.outWigType[0] != "None" and P.outBAMcoord:
            from .io.signal import signal_from_bam
            with _tick("signal"):
                signal_from_bam(prefix + "Aligned.sortedByCoord.out.bam",
                                prefix + "Signal", P)
    with _tick("job_close"):
        if P.outSJtype == "Standard":
            sj.write(prefix + "SJ.out.tab")
        if gene_counts is not None:
            n_unmapped = (stats.unmapped_mm + stats.unmapped_short
                          + stats.unmapped_other + stats.unmapped_multi)
            gene_counts.write(prefix + "ReadsPerGene.out.tab", n_unmapped)
        if chim_stream is not None and P.chimOutTypeSAMold:
            with open(prefix + "Chimeric.out.sam", "w") as f:
                f.write(sam_header(gi_o, P))
                for l in chim_sam_lines:
                    f.write(l + "\n")
        if chim_stream is not None and P.chimOutTypeJunctions:
            with open(prefix + "Chimeric.out.junction", "w") as f:
                if P.chimMultimapNmax > 0:
                    # column header only in multimapping mode
                    # (reference ParametersChimeric_initialize.cpp:48-71)
                    f.write("chr_donorA\tbrkpt_donorA\tstrand_donorA\tchr_acceptorB\tbrkpt_acceptorB\tstrand_acceptorB\tjunction_type\trepeat_left_lenA\trepeat_right_lenB\tread_name\tstart_alnA\tcigar_alnA\tstart_alnB\tcigar_alnB\tnum_chim_aln\tmax_poss_aln_score\tnon_chim_aln_score\tthis_chim_aln_score\tbestall_chim_aln_score\tPEmerged_bool\treadgrp\n")
                for l in chim_lines:
                    f.write(l + "\n")
                if P.chimOutJunctionFormat == 1:
                    f.write(f"# Nreads {stats.read_n}\tNreadsUnique {stats.mapped_reads_u}\tNreadsMulti {stats.mapped_reads_m}\n")
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
               use_device: bool, device=None, mesh=None):
    if P.soloTypeYes and P.soloType[0] != "SmartSeq":
        # the barcode read is the last file; only the cDNA read is aligned
        # (SmartSeq has no barcode read: its wells come from the file index,
        # so it flows through the plain reader below, which tracks it)
        reader = ((name, seqs[:1], quals[:1], ftype, (seqs[1], quals[1]))
                  for name, seqs, quals, ftype
                  in read_pairs(P.readFilesIn[:2], P.readFilesCommand))
        if use_device:
            # stream: the barcodes of the reads in flight wait on a deque
            # (align_stream yields in input order), so memory stays O(batch)
            from collections import deque
            from .ops.pipeline import DeviceAligner
            aligner = DeviceAligner(gi, P, device=device, mesh=mesh)
            pending = deque()

            def plain():
                for i, (name, seqs, quals, ftype, bc) in enumerate(reader):
                    pending.append((i, name, bc))
                    yield name, seqs, quals, ftype
            for res in aligner.align_stream(plain(), stats):
                ii, name, bc = pending.popleft()
                if res.name != name:
                    raise RuntimeError(f"barcode of read {name} paired with "
                                       f"read {res.name}")
                res.solo_bc = bc
                res.i_read_all = ii
                yield res
        else:
            aligner = ReadAligner(gi, P)
            n = 0
            for name, seqs, quals, ftype, bc in reader:
                if P.readMapNumber >= 0 and n >= P.readMapNumber:
                    break
                res = aligner.align_read(name, seqs, quals)
                res.read_file_type = ftype
                res.solo_bc = bc
                res.i_read_all = n
                stats.add_read(res)
                n += 1
                yield res
        return
    reader_idx = read_pairs_indexed(P.readFilesIn[:max(P.readNmates, 1)],
                                    P.readFilesCommand,
                                    sam_mates=P.samInputNmates)
    if use_device:
        from .ops.pipeline import DeviceAligner
        aligner = DeviceAligner(gi, P, device=device, mesh=mesh)
        file_idx = []

        def plain():
            for name, seqs, quals, ftype, ifile, extra in reader_idx:
                file_idx.append((ifile, extra))
                yield name, seqs, quals, ftype
        # align_stream yields in input order (reference-order replay)
        for k, res in enumerate(aligner.align_stream(plain(), stats)):
            res.read_file_index, res.name_extra = file_idx[k]
            res.i_read_all = k
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


def _chimeric_sam_old(tr_chim, res, gi, P):
    """Chimeric.out.sam records for the two chimeric segments (reference
    ReadAlign_chimericDetectionOldOutput.cpp:18-59): primary-flag selection,
    then outputTranscriptSAM with nTr=2 and PE mate fields."""
    from .io.sam import transcript_sam
    t0, t1 = tr_chim[0], tr_chim[1]
    if t0.exons[0][3] != t0.exons[-1][3]:
        t0.primaryFlag, t1.primaryFlag = True, False
    elif t1.exons[0][3] != t1.exons[-1][3]:
        t1.primaryFlag, t0.primaryFlag = True, False
    elif t0.exons[0][3] != t1.exons[0][3]:
        t0.primaryFlag = t1.primaryFlag = True
    else:
        rep = 0 if t0.maxScore > t1.maxScore else 1
        tr_chim[rep].primaryFlag = True
        tr_chim[1 - rep].primaryFlag = False
    lines = []
    for i_tr in range(2):
        tr = tr_chim[i_tr]
        other = tr_chim[1 - i_tr]
        if len(res.seqs) == 2:
            iex = 0
            if other.exons[0][3] != other.exons[-1][3]:
                while iex < other.nExons and \
                        other.exons[iex][3] == tr.exons[0][3]:
                    iex += 1
            lines.append(transcript_sam(
                tr, res, 2, i_tr, gi, P, mate_chr=other.Chr,
                mate_start=other.exons[iex][1],
                mate_strand=int(other.Str != other.exons[iex][3])))
        else:
            lines.append(transcript_sam(tr, res, 2, i_tr, gi, P))
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    P = Parameters(argv)
    if "genomeGenerate" in P.runMode:
        genome_generate(P)
    elif P.runMode[0] == "liftOver":
        from .io.liftover import lift_over_main
        lift_over_main(P)
    elif P.runMode[0] == "soloCellFiltering":
        from .solo.solo import solo_cell_filtering
        solo_cell_filtering(P)
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
