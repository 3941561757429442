"""liftOver runMode: arithmetic lift-over of a GTF through UCSC chain files.

Replicates reference STAR's Chain class (Chain.cpp:10-118, dispatch
STAR.cpp:109-119) byte-identically:

- chain parsing (Chain.cpp chainLoad): header line keyed by tName; block
  starts accumulated as prev_start + prev_len + shift; only a SINGLE chain
  per source chromosome is supported (later chains for the same chr append
  onto the same block vectors, as in the reference).
- per-coordinate transform (liftOverGTF): last-block-<= binary search
  (serviceFuns.cpp binarySearch1a semantics); coordinates inside a block map
  linearly; a start coordinate in a gap snaps to the next block's start; an
  end coordinate in a gap snaps to the previous block's end; otherwise the
  line is unliftable and written verbatim to <out>.unlifted.
- the remainder of each GTF line after the two coordinates is copied
  verbatim (istringstream::rdbuf semantics), preserving original separators.
- reference quirk: STAR exits after processing the FIRST chain file
  (exit(0) inside the loop, STAR.cpp:113-118), so only GTFliftOver_1.gtf is
  ever produced; we replicate that.
"""
from bisect import bisect_right
from typing import Dict, List

UMAX = (1 << 64) - 1  # uint "-1" sentinel (Chain.cpp:101)


class OneChain:
    __slots__ = ("chr2", "bStart1", "bStart2", "bLen")

    def __init__(self):
        self.chr2 = ""
        self.bStart1: List[int] = []
        self.bStart2: List[int] = []
        self.bLen: List[int] = []


def load_chains(chain_file: str) -> Dict[str, OneChain]:
    """Parse a UCSC chain file into per-source-chromosome block lists
    (Chain.cpp:10-63)."""
    chains: Dict[str, OneChain] = {}
    chr1 = ""
    with open(chain_file) as fh:
        for line in fh:
            fields = line.split()
            if not fields:
                continue
            if len(fields) == 1:
                # end of chain: last block has length only
                chains[chr1].bLen.append(int(fields[0]))
            elif len(fields) >= 4 and fields[3] != "":
                # chain header:
                # chain score tName tSize tStrand tStart tEnd qName qSize
                #   qStrand qStart qEnd id
                chr1 = fields[2]
                ch = chains.setdefault(chr1, OneChain())
                ch.chr2 = fields[7]
                ch.bStart1.append(int(fields[5]))
                ch.bStart2.append(int(fields[10]))
            else:
                # block line: size dt dq
                ch = chains[chr1]
                ch.bLen.append(int(fields[0]))
                ch.bStart1.append(ch.bStart1[-1] + ch.bLen[-1] + int(fields[1]))
                ch.bStart2.append(ch.bStart2[-1] + ch.bLen[-1] + int(fields[2]))
    return chains


def _search_last_le(x: int, starts: List[int]) -> int:
    """binarySearch1a: index of last element <= x; -1 if x < starts[0];
    len-1 if x > starts[-1] (serviceFuns.cpp:239-263)."""
    return bisect_right(starts, x) - 1


def lift_over_gtf(chains: Dict[str, OneChain], gtf_file: str,
                  out_file: str) -> None:
    """Lift a GTF through loaded chains (Chain.cpp:66-118)."""
    out = open(out_file, "w")
    out_unlifted = open(out_file + ".unlifted", "w")
    with open(gtf_file) as fh:
        for line in fh:
            line1 = line.rstrip("\n")
            # istringstream >> tokenization: fields 1-5, remainder verbatim
            stripped = line1.lstrip(" \t")
            if stripped == "" or stripped.startswith("#"):
                continue
            # consume 5 whitespace-separated tokens, tracking the cursor so
            # the remainder (rdbuf) keeps its original separators
            pos = 0
            toks = []
            for _ in range(5):
                while pos < len(line1) and line1[pos] in " \t":
                    pos += 1
                start = pos
                while pos < len(line1) and line1[pos] not in " \t":
                    pos += 1
                toks.append(line1[start:pos])
            chr1, str1, str2 = toks[0], toks[1], toks[2]
            if chr1 not in chains:
                raise SystemExit(
                    "EXITING because of fatal INPUT file error: GTF contains "
                    "chromosome " + chr1 + " not present in the chain file")
            ch = chains[chr1]
            bN = len(ch.bLen)
            c2 = [UMAX, UMAX]
            for ii in range(2):
                c1 = int(toks[3 + ii])
                i1 = _search_last_le(c1, ch.bStart1)
                if i1 >= 0 and c1 < ch.bStart1[i1] + ch.bLen[i1]:
                    c2[ii] = ch.bStart2[i1] + c1 - ch.bStart1[i1]
                elif ii == 0 and i1 < bN - 1:
                    c2[ii] = ch.bStart2[i1 + 1]
                elif ii == 1 and i1 >= 0:
                    c2[ii] = ch.bStart2[i1] + ch.bLen[i1] - 1
            if c2[0] != UMAX and c2[1] != UMAX and c2[1] >= c2[0]:
                rest = line1[pos:]
                out.write("%s\t%s\t%s\t%d\t%d%s\n"
                          % (ch.chr2, str1, str2, c2[0], c2[1], rest))
            else:
                out_unlifted.write(line1 + "\n")
    out.close()
    out_unlifted.close()


def lift_over_main(P) -> None:
    """--runMode liftOver driver (STAR.cpp:109-119). Reference exits inside
    the loop, so only the first chain file is processed."""
    for ii, chain_file in enumerate(P.genomeChainFiles):
        chains = load_chains(chain_file)
        lift_over_gtf(chains, P.sjdbGTFfile,
                      P.outFileNamePrefix + "GTFliftOver_%d.gtf" % (ii + 1))
        return
