"""Parameter/flag system.

STAR-compatible flag surface: same flag names, same defaults, same 3-level
precedence (built-in defaults < parameter files < command line), so existing
STAR command lines work unchanged (reference: source/parametersDefault,
source/Parameters.cpp registry).  Internally this is a flat typed registry
materialised onto a Parameters object as attributes.
"""
from __future__ import annotations

import math
import os
import shlex
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class ParamDef:
    name: str
    ptype: str  # 'int', 'float', 'str', 'int_list', 'float_list', 'str_list'
    default: Any


def _convert(ptype: str, tokens: List[str]) -> Any:
    if ptype == "int":
        return int(tokens[0])
    if ptype == "float":
        return float(tokens[0])
    if ptype == "str":
        return tokens[0]
    if ptype == "int_list":
        return [int(t) for t in tokens]
    if ptype == "float_list":
        return [float(t) for t in tokens]
    if ptype == "str_list":
        return list(tokens)
    raise ValueError(ptype)


# Registry of supported flags.  Names and defaults mirror the reference
# aligner's self-documented flag registry one-to-one (values cross-checked
# against reference parametersDefault).
_DEFS: List[ParamDef] = [d for d in [
    # run
    ParamDef("runMode", "str_list", ["alignReads"]),
    ParamDef("runThreadN", "int", 1),
    ParamDef("runDirPerm", "str", "User_RWX"),
    ParamDef("runRNGseed", "int", 777),
    # genome
    ParamDef("genomeDir", "str", "./GenomeDir/"),
    ParamDef("genomeFastaFiles", "str_list", ["-"]),
    ParamDef("genomeLoad", "str", "NoSharedMemory"),
    ParamDef("genomeChrBinNbits", "int", 18),
    ParamDef("genomeSAindexNbases", "int", 14),
    ParamDef("genomeSAsparseD", "int", 1),
    ParamDef("genomeSuffixLengthMax", "int", -1),
    ParamDef("genomeTransformType", "str", "None"),
    ParamDef("genomeTransformVCF", "str", "-"),
    ParamDef("genomeTransformOutput", "str_list", ["None"]),
    # sjdb
    ParamDef("sjdbFileChrStartEnd", "str_list", ["-"]),
    ParamDef("sjdbGTFfile", "str", "-"),
    ParamDef("genomeChainFiles", "str_list", ["-"]),
    ParamDef("sjdbGTFchrPrefix", "str", "-"),
    ParamDef("sjdbGTFfeatureExon", "str", "exon"),
    ParamDef("sjdbGTFtagExonParentTranscript", "str", "transcript_id"),
    ParamDef("sjdbGTFtagExonParentGene", "str", "gene_id"),
    ParamDef("sjdbGTFtagExonParentGeneName", "str_list", ["gene_name"]),
    ParamDef("sjdbGTFtagExonParentGeneType", "str_list", ["gene_type", "gene_biotype"]),
    ParamDef("sjdbOverhang", "int", 100),
    ParamDef("sjdbScore", "int", 2),
    ParamDef("sjdbInsertSave", "str", "Basic"),
    # input
    ParamDef("readFilesIn", "str_list", ["Read1", "Read2"]),
    ParamDef("readFilesType", "str_list", ["Fastx"]),
    ParamDef("readFilesCommand", "str_list", ["-"]),
    ParamDef("readNameSeparator", "str_list", ["/"]),
    ParamDef("readMapNumber", "int", -1),
    ParamDef("readQualityScoreBase", "int", 33),
    # limits
    ParamDef("limitOutSJcollapsed", "int", 1000000),
    ParamDef("limitSjdbInsertNsj", "int", 1000000),
    # output
    ParamDef("outFileNamePrefix", "str", "./"),
    ParamDef("outTmpDir", "str", "-"),
    ParamDef("outStd", "str", "Log"),
    ParamDef("outReadsUnmapped", "str", "None"),
    ParamDef("outQSconversionAdd", "int", 0),
    ParamDef("outMultimapperOrder", "str", "Old_2.4"),
    # SAM output
    ParamDef("outSAMtype", "str_list", ["SAM"]),
    ParamDef("outSAMmode", "str", "Full"),
    ParamDef("outSAMstrandField", "str", "None"),
    ParamDef("outSAMattributes", "str_list", ["Standard"]),
    ParamDef("outSAMunmapped", "str_list", ["None"]),
    ParamDef("outSAMorder", "str", "Paired"),
    ParamDef("outSAMprimaryFlag", "str", "OneBestScore"),
    ParamDef("outSAMreadID", "str", "Standard"),
    ParamDef("outSAMmapqUnique", "int", 255),
    ParamDef("outSAMflagOR", "int", 0),
    ParamDef("outSAMflagAND", "int", 65535),
    ParamDef("outSAMattrRGline", "str_list", ["-"]),
    ParamDef("outSAMheaderHD", "str_list", ["-"]),
    ParamDef("outSAMheaderPG", "str_list", ["-"]),
    ParamDef("outSAMattrIHstart", "int", 1),
    ParamDef("outSAMmultNmax", "int", -1),
    ParamDef("outSAMtlen", "int", 1),
    # filtering
    ParamDef("outFilterType", "str", "Normal"),
    ParamDef("outFilterMultimapScoreRange", "int", 1),
    ParamDef("outFilterMultimapNmax", "int", 10),
    ParamDef("outFilterMismatchNmax", "int", 10),
    ParamDef("outFilterMismatchNoverLmax", "float", 0.3),
    ParamDef("outFilterMismatchNoverReadLmax", "float", 1.0),
    ParamDef("outFilterScoreMin", "int", 0),
    ParamDef("outFilterScoreMinOverLread", "float", 0.66),
    ParamDef("outFilterMatchNmin", "int", 0),
    ParamDef("outFilterMatchNminOverLread", "float", 0.66),
    ParamDef("outFilterIntronMotifs", "str", "None"),
    ParamDef("outFilterIntronStrands", "str", "RemoveInconsistentStrands"),
    # SJ output filtering
    ParamDef("outSJtype", "str", "Standard"),
    ParamDef("outSJfilterReads", "str", "All"),
    ParamDef("outSJfilterOverhangMin", "int_list", [30, 12, 12, 12]),
    ParamDef("outSJfilterCountUniqueMin", "int_list", [3, 1, 1, 1]),
    ParamDef("outSJfilterCountTotalMin", "int_list", [3, 1, 1, 1]),
    ParamDef("outSJfilterDistToOtherSJmin", "int_list", [10, 0, 5, 10]),
    ParamDef("outSJfilterIntronMaxVsReadN", "int_list", [50000, 100000, 200000]),
    # scoring
    ParamDef("scoreGap", "int", 0),
    ParamDef("scoreGapNoncan", "int", -8),
    ParamDef("scoreGapGCAG", "int", -4),
    ParamDef("scoreGapATAC", "int", -8),
    ParamDef("scoreGenomicLengthLog2scale", "float", -0.25),
    ParamDef("scoreDelOpen", "int", -2),
    ParamDef("scoreDelBase", "int", -2),
    ParamDef("scoreInsOpen", "int", -2),
    ParamDef("scoreInsBase", "int", -2),
    ParamDef("scoreStitchSJshift", "int", 1),
    # seeding
    ParamDef("seedSearchStartLmax", "int", 50),
    ParamDef("seedSearchStartLmaxOverLread", "float", 1.0),
    ParamDef("seedSearchLmax", "int", 0),
    ParamDef("seedMultimapNmax", "int", 10000),
    ParamDef("seedPerReadNmax", "int", 1000),
    ParamDef("seedPerWindowNmax", "int", 50),
    ParamDef("seedNoneLociPerWindow", "int", 10),
    ParamDef("seedSplitMin", "int", 12),
    ParamDef("seedMapMin", "int", 5),
    # alignment
    ParamDef("alignIntronMin", "int", 21),
    ParamDef("alignIntronMax", "int", 0),
    ParamDef("alignMatesGapMax", "int", 0),
    ParamDef("alignSJoverhangMin", "int", 5),
    ParamDef("alignSJstitchMismatchNmax", "int_list", [0, -1, 0, 0]),
    ParamDef("alignSJDBoverhangMin", "int", 3),
    ParamDef("alignSplicedMateMapLmin", "int", 0),
    ParamDef("alignSplicedMateMapLminOverLmate", "float", 0.66),
    ParamDef("alignWindowsPerReadNmax", "int", 10000),
    ParamDef("alignTranscriptsPerWindowNmax", "int", 100),
    ParamDef("alignTranscriptsPerReadNmax", "int", 10000),
    ParamDef("alignEndsType", "str", "Local"),
    ParamDef("alignEndsProtrude", "str_list", ["0", "ConcordantPair"]),
    ParamDef("alignSoftClipAtReferenceEnds", "str", "Yes"),
    ParamDef("alignInsertionFlush", "str", "None"),
    # windows
    ParamDef("winAnchorMultimapNmax", "int", 50),
    ParamDef("winBinNbits", "int", 16),
    ParamDef("winAnchorDistNbins", "int", 9),
    ParamDef("winFlankNbins", "int", 4),
    # long-read window selection (reference parametersDefault:675-678; used
    # only by the STARlong build, ReadAlign_stitchPieces.cpp:202-257)
    ParamDef("winReadCoverageRelativeMin", "float", 0.5),
    ParamDef("winReadCoverageBasesMin", "int", 0),
    # two-pass
    ParamDef("twopassMode", "str", "None"),
    ParamDef("twopass1readsN", "int", -1),
    # quant
    ParamDef("quantMode", "str_list", ["-"]),
    ParamDef("quantTranscriptomeBan", "str", "IndelSoftclipSingleend"),
    # signal output
    ParamDef("outWigType", "str_list", ["None"]),
    ParamDef("outWigStrand", "str", "Stranded"),
    ParamDef("outWigNorm", "str", "RPM"),
    ParamDef("outWigReferencesPrefix", "str", "-"),
    ParamDef("inputBAMfile", "str", "-"),
    ParamDef("varVCFfile", "str", "-"),
    ParamDef("waspOutputMode", "str", "None"),
    ParamDef("bamRemoveDuplicatesType", "str", "-"),
    ParamDef("bamRemoveDuplicatesMate2basesN", "int", 0),
    ParamDef("outBAMcompression", "int", 1),
    ParamDef("outBAMsortingBinsN", "int", 50),
    ParamDef("limitBAMsortRAM", "int", 0),
    # chimeric
    ParamDef("chimSegmentMin", "int", 0),
    ParamDef("chimScoreMin", "int", 0),
    ParamDef("chimScoreDropMax", "int", 20),
    ParamDef("chimScoreSeparation", "int", 10),
    ParamDef("chimScoreJunctionNonGTAG", "int", -1),
    ParamDef("chimMainSegmentMultNmax", "int", 10),
    ParamDef("chimSegmentReadGapMax", "int", 0),
    ParamDef("chimFilter", "str_list", ["banGenomicN"]),
    ParamDef("chimOutJunctionFormat", "int", 0),
    ParamDef("chimJunctionOverhangMin", "int", 20),
    ParamDef("chimOutType", "str_list", ["Junctions"]),
    ParamDef("chimMultimapNmax", "int", 0),
    ParamDef("chimMultimapScoreRange", "int", 1),
    ParamDef("chimNonchimScoreDropMin", "int", 20),
    ParamDef("peOverlapNbasesMin", "int", 0),
    ParamDef("peOverlapMMp", "float", 0.01),
    ParamDef("peOverlapSEmerge", "str", "no"),
    # clipping
    ParamDef("clipAdapterType", "str_list", ["Hamming"]),
    ParamDef("clip3pNbases", "int_list", [0]),
    ParamDef("clip3pAdapterSeq", "str_list", ["-"]),
    ParamDef("clip3pAdapterMMp", "str_list", ["0.1"]),
    ParamDef("clip3pAfterAdapterNbases", "int_list", [0]),
    ParamDef("clip5pNbases", "int_list", [0]),
    ParamDef("clip5pAdapterSeq", "str_list", ["-"]),
    ParamDef("clip5pAdapterMMp", "str_list", ["0.1"]),
    ParamDef("clip5pAfterAdapterNbases", "int_list", [0]),
    # solo (accepted now; engine support lands with the solo subsystem)
    ParamDef("soloType", "str_list", ["None"]),
    ParamDef("soloCBstart", "int_list", [1]),
    ParamDef("soloCBlen", "int_list", [16]),
    ParamDef("soloUMIstart", "int_list", [17]),
    ParamDef("soloUMIlen", "int_list", [12]),
    ParamDef("soloCBwhitelist", "str_list", ["-"]),
    ParamDef("soloFeatures", "str_list", ["Gene"]),
    ParamDef("soloCellFilter", "str_list", ["CellRanger2.2", "3000", "0.99", "10"]),
    ParamDef("soloClusterCBfile", "str", "-"),
    ParamDef("soloUMIdedup", "str_list", ["1MM_All"]),
    ParamDef("soloCBmatchWLtype", "str", "1MM_multi"),
    ParamDef("soloStrand", "str", "Forward"),
    ParamDef("soloUMIfiltering", "str_list", ["-"]),
    ParamDef("soloMultiMappers", "str_list", ["Unique"]),
    ParamDef("soloCellReadStats", "str", "None"),
    ParamDef("soloCBposition", "str_list", ["-"]),
    ParamDef("soloUMIposition", "str", "-"),
    ParamDef("soloAdapterSequence", "str", "-"),
    ParamDef("soloAdapterMismatchesNmax", "int", 1),
    ParamDef("readFilesManifest", "str_list", ["-"]),
    # framework-specific (no reference analog): device batching
    ParamDef("tpuBatchSize", "int", 16384),
    ParamDef("tpuUseDevice", "int", 1),
    ParamDef("tpuShardedIndex", "int", 0),
    # long-read mode: the reference ships this as the separately compiled
    # STARlong binary (-DCOMPILE_FOR_LONG_READS, source/Makefile:164); here
    # it is a runtime switch (also set by the bin/star-tpu-long entry)
    ParamDef("tpuLongReads", "int", 0),
] ]

DEFS_BY_NAME: Dict[str, ParamDef] = {d.name: d for d in _DEFS}


class Parameters:
    """Resolved parameter set + derived values."""

    def __init__(self, argv: Optional[List[str]] = None, **overrides):
        for d in _DEFS:
            setattr(self, d.name, d.default if not isinstance(d.default, list) else list(d.default))
        self._user_set: List[str] = []   # user-redefined flags, input order
        if argv:
            self._parse_argv(argv)
        for k, v in overrides.items():
            if k not in DEFS_BY_NAME:
                raise KeyError(f"unknown parameter: {k}")
            setattr(self, k, v)
        self.derive()

    # -- parsing ----------------------------------------------------------
    def _parse_argv(self, argv: List[str]):
        i = 0
        pending: Dict[str, List[str]] = {}
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("--"):
                raise ValueError(f"expected --flag, got: {tok}")
            name = tok[2:]
            vals = []
            i += 1
            while i < len(argv) and not argv[i].startswith("--"):
                vals.append(argv[i])
                i += 1
            pending[name] = vals
        if "parametersFiles" in pending:
            for fn in pending.pop("parametersFiles"):
                if fn != "-":
                    self._parse_file(fn)
        for name, vals in pending.items():
            self.set_flag(name, vals)
            if name not in self._user_set:
                self._user_set.append(name)

    def _parse_file(self, path: str):
        with open(path) as f:
            for line in f:
                line = line.split("//")[0].strip()
                if not line or line.startswith("#"):
                    continue
                toks = shlex.split(line)
                self.set_flag(toks[0], toks[1:])

    def set_flag(self, name: str, tokens: List[str]):
        d = DEFS_BY_NAME.get(name)
        if d is None:
            raise ValueError(
                f"unknown parameter: --{name}\n"
                f"SOLUTION: check spelling against the supported flag list")
        setattr(self, name, _convert(d.ptype, tokens))

    # -- derived ----------------------------------------------------------
    def _init_read_files(self):
        """readFilesManifest + outSAMattrRGline parsing (reference
        Parameters_readFilesInit.cpp:42-135)"""
        self.outSAMattrRGlineSplit: List[str] = []
        self.outSAMattrRG: List[str] = []
        if self.readFilesManifest[0] != "-":
            m1, m2 = [], []
            with open(self.readFilesManifest[0]) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line.strip():
                        continue
                    cols = line.split("\t")
                    if len(cols) < 3:
                        raise SystemExit(
                            "EXITING because of FATAL INPUT FILE error: "
                            f"readFileManifest file {self.readFilesManifest[0]}"
                            " has to contain at least 3 tab separated columns"
                            "\nSOLUTION: fix the formatting of the "
                            "readFileManifest file: Read1 <tab> Read2 <tab> "
                            "ReadGroup. For single-end reads, use - in the "
                            "2nd column.")
                    m1.append(cols[0])
                    m2.append(cols[1])
                    rg = "\t".join(cols[2:])
                    if not rg.startswith("ID:"):
                        rg = "ID:" + rg
                    self.outSAMattrRGlineSplit.append(rg)
                    self.outSAMattrRG.append(rg[3:].split("\t")[0])
            # SE iff the first row's 2nd column is "-" (readFilesInit:135)
            if m2[0].endswith("-"):
                self.readFilesIn = [",".join(m1)]
            else:
                self.readFilesIn = [",".join(m1), ",".join(m2)]
        elif self.outSAMattrRGline[0] != "-":
            entry: List[str] = []
            for tok in self.outSAMattrRGline + [","]:
                if tok == ",":
                    if entry:
                        if not entry[0].startswith("ID:"):
                            raise SystemExit(
                                "EXITING because of FATAL INPUT ERROR: the "
                                "first word of a line from --outSAMattrRGline="
                                f"{entry[0]} does not start with ID:xxx read "
                                "group identifier\nSOLUTION: re-run STAR with "
                                "all lines in --outSAMattrRGline starting "
                                "with ID:xxx")
                        self.outSAMattrRGlineSplit.append("\t".join(entry))
                        self.outSAMattrRG.append(entry[0][3:])
                    entry = []
                else:
                    entry.append(tok)
            n_files = len(self.readFilesIn[0].split(","))
            if len(self.outSAMattrRG) > 1 \
                    and len(self.outSAMattrRG) != n_files:
                raise SystemExit(
                    "EXITING: because of fatal INPUT ERROR: number of input "
                    f"read files: {n_files} does not agree with number of "
                    f"read group RG entries: {len(self.outSAMattrRG)}\n"
                    "Make sure that the number of RG lines in "
                    "--outSAMattrRGline is equal to either 1, or the number "
                    "of input read files in --readFilesIn")
            elif len(self.outSAMattrRG) == 1:
                self.outSAMattrRG *= n_files

    def derive(self):
        self._init_read_files()
        # --readFilesType SAM SE/PE: one input stream carrying both mates
        # (reference Parameters.cpp readFilesTypeN=10)
        self.readFilesTypeN = 10 if self.readFilesType[0] == "SAM" else 0
        self.samInputNmates = 0
        if self.readFilesTypeN == 10:
            if len(self.readFilesType) < 2 or self.readFilesType[1] not in ("SE", "PE"):
                raise SystemExit(
                    "EXITING because of fatal PARAMETERS error: --readFilesType "
                    "SAM requires SE or PE\nSOLUTION: use --readFilesType SAM "
                    "SE or --readFilesType SAM PE")
            self.samInputNmates = 1 if self.readFilesType[1] == "SE" else 2
        if self.readFilesTypeN == 10:
            self.readNmates = self.samInputNmates
        else:
            self.readNmates = 1 if (len(self.readFilesIn) < 2 or self.readFilesIn[1] in ("", "-")) else 2
        if self.soloType[0] != "None" and self.soloType[0] != "SmartSeq":
            self.readNmates = 1  # the barcode read is not aligned
        self.readNends = self.readNmates  # barcodes add ends later (solo)
        self.maxNsplit = 10
        # long-read build constants (reference IncludeDefine.h:128-140:
        # MAX_N_EXONS 20 -> 1000, DEF_readSeqLengthMax 650 -> 500000 under
        # COMPILE_FOR_LONG_READS)
        self.longReads = bool(self.tpuLongReads)
        self.maxNExons = 1000 if self.longReads else 20
        self.readSeqLengthMax = 500000 if self.longReads else 650
        self.outSAMbool = "SAM" in self.outSAMtype
        self.outBAMunsorted = ("BAM" in self.outSAMtype) and ("Unsorted" in self.outSAMtype)
        self.outBAMcoord = ("BAM" in self.outSAMtype) and ("SortedByCoordinate" in self.outSAMtype)
        self.outSAMunmappedWithin = "Within" in self.outSAMunmapped
        self.outSAMunmappedKeepPairs = "KeepPairs" in self.outSAMunmapped
        self.outFilterBySJoutStage = 0 if self.outFilterType != "BySJout" else 1
        self.alignEndsTypeExt = {
            "Local": ((False, False), (False, False)),
            "EndToEnd": ((True, True), (True, True)),
            "Extend5pOfRead1": ((True, False), (False, False)),
            "Extend5pOfReads12": ((True, False), (True, False)),
        }[self.alignEndsType]
        self.alignEndsProtrudeMax = int(self.alignEndsProtrude[0])
        self.alignEndsProtrudeConcordant = (
            len(self.alignEndsProtrude) > 1 and self.alignEndsProtrude[1] == "ConcordantPair")
        self.alignInsertionFlushRight = self.alignInsertionFlush == "Right"
        self.outMultimapperOrderRandom = self.outMultimapperOrder == "Random"
        # standard attribute order
        attrs = list(self.outSAMattributes)
        if attrs == ["Standard"]:
            attrs = ["NH", "HI", "AS", "nM"]
        elif attrs == ["All"]:
            attrs = ["NH", "HI", "AS", "nM", "NM", "MD", "jM", "jI", "MC", "ch"]
        elif attrs == ["None"]:
            attrs = []
        if ("WithinBAM" in self.chimOutType and self.chimSegmentMin >= 0
                and "NM" not in attrs):
            # WithinBAM forces the NM attribute for the SA tags
            # (ParametersChimeric_initialize.cpp:99-102)
            attrs = attrs + ["NM"]
        self.samAttrOrder = attrs
        for a in ("ch", "CR", "CY", "UR", "UY", "CB", "UB", "sM", "sS", "sQ",
                  "GX", "GN"):  # Parameters_samAttributes.cpp:226-242
            if a in attrs and not (self.outBAMunsorted or self.outBAMcoord):
                raise SystemExit(
                    f"EXITING because of fatal PARAMETER error: "
                    f"--outSAMattributes contains {a} tag, which requires BAM "
                    f"output.\nSOLUTION: re-run STAR with --outSAMtype BAM "
                    f"Unsorted (and/or) SortedByCoordinate option, or without "
                    f"{a} tag in --outSAMattributes")
        # WASP (Parameters.cpp:861-887)
        self.waspYes = False
        if self.waspOutputMode == "SAMtag":
            self.waspYes = True
        elif self.waspOutputMode != "None":
            raise SystemExit(
                "EXITING because of FATAL INPUT ERROR: unknown/unimplemented "
                f"--waspOutputMode option: {self.waspOutputMode}\nSOLUTION: "
                "re-run STAR with allowed --waspOutputMode options: None or SAMtag")
        if self.waspYes and self.varVCFfile == "-":
            raise SystemExit(
                "EXITING because of FATAL INPUT ERROR: --waspOutputMode "
                f"option requires VCF file: {self.waspOutputMode}\nSOLUTION: "
                "re-run STAR with --waspOutputMode ... and --varVCFfile /path/to/file.vcf")
        if self.waspYes and self.outSAMtype[0] != "BAM":
            raise SystemExit(
                "EXITING because of FATAL INPUT ERROR: --waspOutputMode "
                "requires output to BAM file\nSOLUTION: re-run STAR with "
                "--waspOutputMode ... and --outSAMtype BAM ... ")
        self.outSAMattrCBUB = "CB" in attrs or "UB" in attrs
        if self.soloType[0] == "CB_samTagOut":
            # corrected CB is emitted at alignment time, any BAM output
            # (reference ParametersSolo.cpp:405-416)
            if "UB" in attrs:
                raise SystemExit(
                    "EXITING because of fatal PARAMETERS error: UB attribute "
                    "(corrected UMI) in --outSAMattributes cannot be used "
                    "with --soloType CB_samTagOut\nSOLUTION: remove UB from "
                    "--outSAMattributes")
            self.outSAMattrCBUB = False
        if self.outSAMattrCBUB and "SortedByCoordinate" not in self.outSAMtype:
            raise SystemExit(
                "EXITING because of fatal PARAMETERS error: CB and/or UB "
                "attributes in --outSAMattributes can only be output in the "
                "sorted BAM file.\nSOLUTION: re-run STAR with --outSAMtype "
                "BAM SortedByCoordinate ...")
        self.quantModeGeneCounts = "GeneCounts" in self.quantMode
        self.quantModeTrSAM = "TranscriptomeSAM" in self.quantMode
        ban = self.quantTranscriptomeBan
        self.quantTrSAMindel = ban == "Singleend"
        self.quantTrSAMsoftClip = ban == "Singleend"
        self.quantTrSAMsingleEnd = False
        self.twopassYes = self.twopassMode == "Basic"
        # STARconsensus genome transform (ParametersGenome.cpp:27-38)
        self.transformTypeN = {"None": 0, "Haploid": 1, "Diploid": 2}.get(
            self.genomeTransformType, 0)
        self.transformOutSAM = "SAM" in self.genomeTransformOutput
        self.transformOutSJ = "SJ" in self.genomeTransformOutput
        self.transformOutQuant = "Quant" in self.genomeTransformOutput
        self.transformOutYes = (self.transformOutSAM or self.transformOutSJ
                                or self.transformOutQuant)
        self.chimMainSegmentMultNmaxEff = self.chimMainSegmentMultNmax
        self.chimFilterGenomicN = "banGenomicN" in self.chimFilter
        self.chimOutTypeJunctions = "Junctions" in self.chimOutType
        self.chimOutTypeSAMold = "SeparateSAMold" in self.chimOutType
        self.chimOutTypeWithinBAM = "WithinBAM" in self.chimOutType
        self.chimOutTypeHardClip = "SoftClip" not in self.chimOutType
        self.soloTypeYes = self.soloType[0] != "None"
        return self

    def clone(self, **over) -> "Parameters":
        import copy
        p = copy.copy(self)
        for k, v in over.items():
            setattr(p, k, v)
        p.derive()
        return p
