"""Read input: FASTQ / multi-line FASTA / SAM (host side).

Supports plain and process-substituted (readFilesCommand) inputs, multi-file
comma lists, and --readFilesType SAM SE/PE remapping input, mirroring the
reference's input surface (reference: source/readLoad.cpp,
source/Parameters_openReadsFiles.cpp,
source/ReadAlignChunk_processChunks.cpp:18-238).
"""
from __future__ import annotations

import subprocess
from typing import Iterator, List, Optional, Tuple

_RC = {"A": "T", "C": "G", "G": "C", "T": "A", "a": "t", "c": "g",
       "g": "c", "t": "a", "N": "N", "n": "n"}


def _open_one(path: str, command):
    if command and command[0] != "-":
        proc = subprocess.Popen(command + [path], stdout=subprocess.PIPE, text=True)
        return proc.stdout
    return open(path)


def _records(stream) -> Iterator[Tuple[str, str, str, int]]:
    """yield (name, seq, qual, file_type) where file_type: 1=fasta 2=fastq.
    FASTA records may span multiple lines (reference converts them to one,
    ReadAlignChunk_processChunks.cpp:160-189)."""
    pushback = None
    while True:
        header = pushback if pushback is not None else stream.readline()
        pushback = None
        if not header:
            return
        header = header.rstrip("\n")
        if not header:
            continue
        if header.startswith("@"):
            seq = stream.readline().rstrip("\n")
            stream.readline()  # +
            qual = stream.readline().rstrip("\n")
            yield header[1:].split()[0], seq, qual, 2
        elif header.startswith(">"):
            parts = []
            while True:
                line = stream.readline()
                if not line or line[0] in ">@ \n":
                    pushback = line if line else None
                    break
                parts.append(line.rstrip("\n"))
            seq = "".join(parts)
            yield header[1:].split()[0], seq, "A" * len(seq), 1
        else:
            raise ValueError(f"bad read header: {header}")


def _revcomp(s: str) -> str:
    return "".join(_RC.get(c, "N") for c in reversed(s))


def _sam_records(stream, n_mates: int) -> Iterator[Tuple[str, List[str], List[str]]]:
    """yield (name, seqs, quals) from SAM text input (reference
    ReadAlignChunk_processChunks.cpp:27-108): @ lines are headers; PE reads
    are two consecutive lines with 0x40/0x80 mate flags; 0x10 restores the
    original orientation by reverse-complementing."""
    for line in stream:
        if not line or line[0] == "@" or line == "\n":
            continue
        f = line.rstrip("\n").split("\t")
        name, flag = f[0], int(f[1])
        seqs = [None] * n_mates
        quals = [None] * n_mates
        extras = [""] * n_mates
        rows = [(name, flag, f[9], f[10], "\t".join(f[11:]))]
        if n_mates == 2:
            line2 = stream.readline()
            f2 = line2.rstrip("\n").split("\t")
            if f2[0] != name:
                raise SystemExit(
                    "EXITING because of FATAL ERROR in input SAM/BAM file: "
                    "the consecutive lines in paired-end SAM have different "
                    f"read IDs:\n{name}   vs   {f2[0]}\nSOLUTION: fix SAM "
                    "file formatting. Paired-end reads should be always "
                    "consecutive lines, with exactly 2 lines per paired-end "
                    "read")
            flag2 = int(f2[1])
            if not (((flag & 0x40) and (flag2 & 0x80))
                    or ((flag2 & 0x40) and (flag & 0x80))):
                raise SystemExit(
                    "EXITING because of FATAL ERROR in input SAM/BAM file: "
                    "the consecutive lines in paired-end SAM have wrong mate "
                    "FLAG bits\nSOLUTION: fix SAM file formatting. Mate1 "
                    "should have 0x40 bit set in the FLAG, Mate2 should have "
                    "0x80 bit set")
            rows.append((f2[0], flag2, f2[9], f2[10], "\t".join(f2[11:])))
        for k, (nm, fl, sq, ql, ex) in enumerate(rows):
            if fl & 0x10:
                sq = _revcomp(sq)
                ql = ql[::-1]
            if k == 0:
                imate = 1 if (n_mates == 2 and (fl & 0x80)) else 0
            else:
                imate = 1 - imate
            seqs[imate] = sq
            quals[imate] = ql
            extras[imate] = ex
        yield name, seqs, quals, extras


def read_pairs(files_in: List[str], command=None) -> Iterator[Tuple[str, List[str], List[str], int]]:
    """yield (name, [seqs...], [quals...], file_type) for SE or PE input."""
    for name, seqs, quals, ftype, _, _ in read_pairs_indexed(files_in, command):
        yield name, seqs, quals, ftype


def read_pairs_indexed(files_in: List[str], command=None, sam_mates: int = 0
                       ) -> Iterator[Tuple[str, List[str], List[str], int, int]]:
    """read_pairs + the input-file index per read (the reference's
    readFilesIndex, used for RG attributes and SmartSeq well ids).
    sam_mates > 0 selects --readFilesType SAM SE/PE input (one stream)."""
    if sam_mates > 0:
        for i_file, path in enumerate(files_in[0].split(",")):
            stream = _open_one(path, command)
            for name, seqs, quals, extras in _sam_records(stream, sam_mates):
                name = _clean_name(name)
                yield name, seqs, quals, 2, i_file, extras
            stream.close()
        return
    mate_files = [f.split(",") for f in files_in if f not in ("", "-")]
    n_mates = len(mate_files)
    for i_file in range(len(mate_files[0])):
        streams = [_open_one(mate_files[m][i_file], command) for m in range(n_mates)]
        iters = [_records(s) for s in streams]
        while True:
            recs = []
            stop = False
            for it in iters:
                r = next(it, None)
                if r is None:
                    stop = True
                    break
                recs.append(r)
            if stop:
                break
            name = _clean_name(recs[0][0])
            yield (name, [r[1] for r in recs], [r[2] for r in recs],
                   recs[0][3], i_file, None)
        for s in streams:
            s.close()


def _clean_name(name: str) -> str:
    for sep in "/ ":
        idx = name.find(sep)
        if idx >= 0:
            name = name[:idx]
    return name
