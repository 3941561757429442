"""GenomeIndex: in-memory genome index + disk formats.

Two on-disk formats are supported:
  * our native format (``star_tpu.idx.npz`` + STAR-style text metadata), and
  * reference STAR index directories (Genome / SA / SAindex packed binaries,
    reference: source/PackedArray.h bit layout, source/Genome_genomeLoad.cpp),
    so existing indexes can be consumed directly and index builds can be
    validated bit-for-bit against the reference.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np

from .fasta import scan_fasta_files, chr_bin_fill, build_t2
from .generate import sort_suffixes, build_sai

INDEX_VERSION = "star_tpu.1"


@dataclass
class GenomeIndex:
    G: np.ndarray                 # int8 [nGenome] codes 0-5
    t2: np.ndarray                # int8 [2*nGenome] doubled search text
    sa: np.ndarray                # int64 [nSA] combined suffix positions
    sai_level_start: np.ndarray   # int64 [L+1]
    sai_val: np.ndarray           # int64
    sai_absent: np.ndarray        # bool
    sai_nbit: np.ndarray          # bool
    chr_name: list
    chr_start: np.ndarray         # int64 [nChr+1]
    chr_length: np.ndarray        # int64 [nChr]
    chr_bin_nbits: int
    sa_index_nbases: int
    sa_sparse_d: int = 1
    # sjdb ("junction chromosome") tables; empty when no annotation
    sjdb_n: int = 0
    sj_gstart: int = 1 << 62      # first genome coordinate of the sj region
    sjdb_overhang: int = 0
    sj_dstart: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sj_astart: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sjdb_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sjdb_end: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sjdb_motif: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    sjdb_shift_left: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    sjdb_shift_right: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    sjdb_strand: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    transform_type: int = 0   # STARconsensus: 0 none / 1 haploid / 2 diploid

    @property
    def n_genome(self) -> int:
        return len(self.G)

    @property
    def n_sa(self) -> int:
        return len(self.sa)

    @property
    def n_chr_real(self) -> int:
        return len(self.chr_name)

    def __post_init__(self):
        self.chr_bin = chr_bin_fill(self.chr_start, 1 << self.chr_bin_nbits)
        self._g_bytes = None
        self._t2_bytes = None
        # device copies of this index (ops/pipeline.py DeviceAligner), keyed
        # by (query window, device); they live and die with the index
        self._device_cache = {}

    @property
    def G_bytes(self) -> bytes:
        """genome as a bytes object: per-base indexing from Python is ~10x
        faster than numpy scalar indexing in the host stitch loops"""
        if self._g_bytes is None:
            self._g_bytes = self.G.tobytes()
        return self._g_bytes

    @property
    def t2_bytes(self) -> bytes:
        if self._t2_bytes is None:
            self._t2_bytes = self.t2.tobytes()
        return self._t2_bytes

    @property
    def sjdb_length(self) -> int:
        return 0 if self.sjdb_overhang == 0 else 2 * self.sjdb_overhang + 1

    # ------------------------------------------------------------------ build
    @classmethod
    def generate(cls, fasta_files, chr_bin_nbits=18, sa_index_nbases=14,
                 sa_sparse_d=1) -> "GenomeIndex":
        G, names, chr_start, chr_length = scan_fasta_files(fasta_files, 1 << chr_bin_nbits)
        t2 = build_t2(G)
        sa = sort_suffixes(t2)
        if sa_sparse_d > 1:
            # sparse suffix array: keep every sa_sparse_d-th position.  The
            # reference strides over its REVERSED text coordinate ii and
            # stores 2N-1-ii (Genome_genomeGenerate.cpp:184,266-272), so the
            # kept forward positions satisfy (2N-1-p) % d == 0.  A subset of
            # a sorted array keeps the reference row order.
            sa = sa[(len(t2) - 1 - sa) % sa_sparse_d == 0]
        sai = build_sai(t2, sa, sa_index_nbases)
        return cls(G=G, t2=t2, sa=sa,
                   sai_level_start=sai["level_start"], sai_val=sai["val"],
                   sai_absent=sai["absent"], sai_nbit=sai["nbit"],
                   chr_name=names, chr_start=chr_start, chr_length=chr_length,
                   chr_bin_nbits=chr_bin_nbits, sa_index_nbases=sa_index_nbases,
                   sa_sparse_d=sa_sparse_d)

    @classmethod
    def from_arrays(cls, d: dict) -> "GenomeIndex":
        """an index from its fields given as numpy arrays and ints (for
        example the fields of another package's GenomeIndex); keys that are
        not fields are ignored, and a missing t2 is rebuilt from G"""
        names = [f.name for f in fields(cls)]
        kw = {k: d[k] for k in names if k in d}
        kw["G"] = np.asarray(kw["G"], dtype=np.int8)
        kw["t2"] = (build_t2(kw["G"]) if kw.get("t2") is None
                    else np.asarray(kw["t2"], dtype=np.int8))
        kw["chr_name"] = list(kw["chr_name"])
        for k in ("chr_bin_nbits", "sa_index_nbases", "sa_sparse_d", "sjdb_n",
                  "sj_gstart", "sjdb_overhang", "transform_type"):
            if k in kw:
                kw[k] = int(kw[k])
        return cls(**kw)

    # ------------------------------------------------------------------- disk
    def save(self, genome_dir: str):
        os.makedirs(genome_dir, exist_ok=True)
        # uncompressed + narrowest dtype: random-genome tables barely
        # compress, and deflate costs minutes at chromosome scale
        sa = self.sa
        sai_val = self.sai_val
        if len(sa) and 2 * self.n_genome < 2**31:
            sa = sa.astype(np.int32)
            sai_val = sai_val.astype(np.int32)
        np.savez(
            os.path.join(genome_dir, "star_tpu.idx.npz"),
            G=self.G, sa=sa,
            sai_level_start=self.sai_level_start, sai_val=sai_val,
            sai_absent=self.sai_absent, sai_nbit=self.sai_nbit,
            chr_start=self.chr_start, chr_length=self.chr_length,
            sjdb_tables=np.array([self.sjdb_n, self.sj_gstart, self.sjdb_overhang], dtype=np.int64),
            sj_dstart=self.sj_dstart, sj_astart=self.sj_astart,
            sjdb_start=self.sjdb_start, sjdb_end=self.sjdb_end,
            sjdb_motif=self.sjdb_motif, sjdb_shift_left=self.sjdb_shift_left,
            sjdb_shift_right=self.sjdb_shift_right, sjdb_strand=self.sjdb_strand)
        meta = {
            "version": INDEX_VERSION,
            "chrName": self.chr_name,
            "genomeChrBinNbits": self.chr_bin_nbits,
            "genomeSAindexNbases": self.sa_index_nbases,
            "genomeSAsparseD": self.sa_sparse_d,
            "sjdbOverhang": self.sjdb_overhang,
            "genomeTransformType": self.transform_type,
        }
        with open(os.path.join(genome_dir, "star_tpu.meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        # STAR-style text metadata for interoperability
        with open(os.path.join(genome_dir, "chrName.txt"), "w") as f:
            f.write("".join(n + "\n" for n in self.chr_name))
        with open(os.path.join(genome_dir, "chrStart.txt"), "w") as f:
            f.write("".join(f"{int(s)}\n" for s in self.chr_start))
        with open(os.path.join(genome_dir, "chrLength.txt"), "w") as f:
            f.write("".join(f"{int(s)}\n" for s in self.chr_length))
        with open(os.path.join(genome_dir, "chrNameLength.txt"), "w") as f:
            f.write("".join(f"{n}\t{int(l)}\n" for n, l in zip(self.chr_name, self.chr_length)))
        with open(os.path.join(genome_dir, "genomeParameters.txt"), "w") as f:
            f.write(f"versionGenome\t{INDEX_VERSION}\n")
            f.write(f"genomeChrBinNbits\t{self.chr_bin_nbits}\n")
            f.write(f"genomeSAindexNbases\t{self.sa_index_nbases}\n")
            f.write(f"genomeSAsparseD\t{self.sa_sparse_d}\n")
            f.write(f"sjdbOverhang\t{self.sjdb_overhang}\n")
            f.write("genomeTransformType\t%s\n"
                    % {0: "None", 1: "Haploid", 2: "Diploid"}[self.transform_type])

    @classmethod
    def load(cls, genome_dir: str) -> "GenomeIndex":
        native = os.path.join(genome_dir, "star_tpu.idx.npz")
        if os.path.exists(native):
            return cls._load_native(genome_dir)
        if os.path.exists(os.path.join(genome_dir, "SA")):
            return cls.load_reference_dir(genome_dir)
        raise FileNotFoundError(f"no index found in {genome_dir}")

    @classmethod
    def _load_native(cls, genome_dir: str) -> "GenomeIndex":
        z = np.load(os.path.join(genome_dir, "star_tpu.idx.npz"))
        with open(os.path.join(genome_dir, "star_tpu.meta.json")) as f:
            meta = json.load(f)
        G = z["G"]
        sjn, sjg, sjo = [int(x) for x in z["sjdb_tables"]]
        return cls(G=G, t2=build_t2(G), sa=z["sa"].astype(np.int64),
                   sai_level_start=z["sai_level_start"],
                   # keep the narrow on-disk dtype: widening the ~4^14-entry
                   # SAi costs seconds and gigabytes for nothing
                   sai_val=z["sai_val"],
                   sai_absent=z["sai_absent"], sai_nbit=z["sai_nbit"],
                   chr_name=list(meta["chrName"]), chr_start=z["chr_start"],
                   chr_length=z["chr_length"],
                   chr_bin_nbits=meta["genomeChrBinNbits"],
                   sa_index_nbases=meta["genomeSAindexNbases"],
                   sa_sparse_d=meta["genomeSAsparseD"],
                   sjdb_n=sjn, sj_gstart=sjg, sjdb_overhang=sjo,
                   transform_type=int(meta.get("genomeTransformType", 0)),
                   sj_dstart=z["sj_dstart"], sj_astart=z["sj_astart"],
                   sjdb_start=z["sjdb_start"], sjdb_end=z["sjdb_end"],
                   sjdb_motif=z["sjdb_motif"],
                   sjdb_shift_left=z["sjdb_shift_left"],
                   sjdb_shift_right=z["sjdb_shift_right"],
                   sjdb_strand=z["sjdb_strand"])

    # -------------------------------------------- reference STAR index reader
    @classmethod
    def load_reference_dir(cls, genome_dir: str) -> "GenomeIndex":
        params = _read_genome_parameters(os.path.join(genome_dir, "genomeParameters.txt"))
        chr_name = _read_lines(os.path.join(genome_dir, "chrName.txt"))
        chr_start = np.array(_read_lines(os.path.join(genome_dir, "chrStart.txt")), dtype=np.int64)
        chr_length = np.array(_read_lines(os.path.join(genome_dir, "chrLength.txt")), dtype=np.int64)
        n_genome_pad = int(chr_start[-1])
        with open(os.path.join(genome_dir, "Genome"), "rb") as f:
            G = np.frombuffer(f.read(), dtype=np.int8)
        sjdb_overhang = int(params.get("sjdbOverhang", 0))
        ttype = {"None": 0, "Haploid": 1, "Diploid": 2}.get(
            str(params.get("genomeTransformType", "None")), 0)
        sjdb_kw = {"transform_type": ttype}
        n_genome = n_genome_pad
        sjdb_info = os.path.join(genome_dir, "sjdbInfo.txt")
        if os.path.exists(sjdb_info):
            sjdb_kw.update(_read_sjdb_info(sjdb_info, n_genome_pad))
            n_genome = n_genome_pad + sjdb_kw.pop("_n_sj_bases")
        G = G[:n_genome]
        limit_sjdb_insert = 1000000
        sjdb_length = 0 if sjdb_overhang == 0 else 2 * sjdb_overhang + 1
        gstrand_bit = max(32, int(np.floor(np.log2(n_genome + limit_sjdb_insert * max(sjdb_length, 1)))) + 1) \
            if sjdb_length > 0 else 32
        if sjdb_length == 0:
            gstrand_bit = max(32, int(np.floor(np.log2(n_genome))) + 1)
        with open(os.path.join(genome_dir, "SA"), "rb") as f:
            sa_bytes = np.frombuffer(f.read(), dtype=np.uint8)
        word_len = gstrand_bit + 1
        # invert the reference allocation lengthByte=(n-1)*w/8+8
        # (reference: PackedArray.cpp:13)
        n_sa = ((len(sa_bytes) - 8) * 8 + 7) // word_len + 1
        sa_packed = unpack_bits(sa_bytes, word_len, n_sa)
        strand = sa_packed >> gstrand_bit
        pos = sa_packed & ((1 << gstrand_bit) - 1)
        sa = np.where(strand == 0, pos, n_genome + pos).astype(np.int64)
        # SAindex
        with open(os.path.join(genome_dir, "SAindex"), "rb") as f:
            hdr = np.frombuffer(f.read(8), dtype=np.uint64)
            L = int(hdr[0])
            level_start = np.frombuffer(f.read(8 * (L + 1)), dtype=np.uint64).astype(np.int64)
            sai_bytes = np.frombuffer(f.read(), dtype=np.uint8)
        sai_word = gstrand_bit + 3
        n_sai = int(level_start[-1])
        sai_packed = unpack_bits(sai_bytes, sai_word, n_sai)
        nbit = ((sai_packed >> (gstrand_bit + 1)) & 1).astype(bool)
        absent = ((sai_packed >> (gstrand_bit + 2)) & 1).astype(bool)
        val = (sai_packed & ((1 << (gstrand_bit + 1)) - 1)).astype(np.int64)
        return cls(G=G, t2=build_t2(G), sa=sa,
                   sai_level_start=level_start, sai_val=val,
                   sai_absent=absent, sai_nbit=nbit,
                   chr_name=chr_name, chr_start=chr_start, chr_length=chr_length,
                   chr_bin_nbits=int(params.get("genomeChrBinNbits", 18)),
                   sa_index_nbases=L,
                   sa_sparse_d=int(params.get("genomeSAsparseD", 1)),
                   sjdb_overhang=sjdb_overhang, **sjdb_kw)


def unpack_bits(raw: np.ndarray, word_len: int, n: int) -> np.ndarray:
    """Decode n little-endian packed word_len-bit values (reference:
    source/PackedArray.h readPacked: 8-byte load at bit offset, shift, mask)."""
    bit_starts = np.arange(n, dtype=np.int64) * word_len
    byte_starts = bit_starts >> 3
    shifts = (bit_starts & 7).astype(np.uint64)
    buf = np.zeros(len(raw) + 8, dtype=np.uint8)
    buf[:len(raw)] = raw
    words = np.lib.stride_tricks.sliding_window_view(buf, 8)[byte_starts]
    vals = words.astype(np.uint64) @ (np.uint64(1) << (np.uint64(8) * np.arange(8, dtype=np.uint64)))
    mask = (np.uint64(1) << np.uint64(word_len)) - np.uint64(1)
    return ((vals >> shifts) & mask).astype(np.int64)


def _read_lines(path):
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def _read_genome_parameters(path):
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = parts[1].strip()
    return out


def _read_sjdb_info(path, sj_gstart):
    """Parse sjdbInfo.txt: first line 'nSJ sjdbOverhang', then per-junction
    start end motif shiftLeft shiftRight strand (reference sjdbPrepare.cpp)."""
    with open(path) as f:
        first = f.readline().split()
        n_sj, overhang = int(first[0]), int(first[1])
        rows = np.loadtxt(f, dtype=np.int64, ndmin=2) if n_sj else np.zeros((0, 6), np.int64)
    sjdb_length = 2 * overhang + 1 if overhang > 0 else 0
    d = {
        "sjdb_n": n_sj,
        "sj_gstart": sj_gstart,
        "_n_sj_bases": n_sj * sjdb_length,
        "sjdb_start": rows[:, 0].copy() if n_sj else np.zeros(0, np.int64),
        "sjdb_end": rows[:, 1].copy() if n_sj else np.zeros(0, np.int64),
        "sjdb_motif": rows[:, 2].astype(np.int8) if n_sj else np.zeros(0, np.int8),
        "sjdb_shift_left": rows[:, 3].astype(np.int8) if n_sj else np.zeros(0, np.int8),
        "sjdb_shift_right": rows[:, 4].astype(np.int8) if n_sj else np.zeros(0, np.int8),
        "sjdb_strand": rows[:, 5].astype(np.int8) if n_sj else np.zeros(0, np.int8),
    }
    if n_sj:
        d["sj_dstart"] = rows[:, 0] - overhang
        d["sj_astart"] = rows[:, 1] + 1
    return d
