"""Core constants shared across the framework.

Numeric nucleotide codes and junction-motif conventions follow the reference
STAR on-disk/output semantics (reference: source/IncludeDefine.h) so that our
outputs are comparable byte-for-byte; the internal architecture is our own.
"""

# nucleotide codes: 0=A 1=C 2=G 3=T, 4=N, 5=chromosome spacer
A, C, G, T, N_BASE, SPACER = 0, 1, 2, 3, 4, 5

# marker placed between paired-end mates in the combined read
MARK_FRAG_SPACER_BASE = 11

MAX_N_EXONS = 20

# canonical splice-junction codes (canonSJ):
#  -3 mate gap, -2 insertion, -1 deletion, 0 non-canonical,
#  1 GT/AG, 2 CT/AC, 3 GC/AG, 4 CT/GC, 5 AT/AC, 6 GT/AT
SJ_MATE_GAP = -3
SJ_INSERTION = -2
SJ_DELETION = -1
SJ_NONCANONICAL = 0

SJ_MOTIF_SIZE = 7
SJ_SAM_ANNOTATED_MOTIF_SHIFT = 20

SCORE_MATCH = 1

# unmapped-read classification (uT:A: SAM tag)
UNMAP_NO_WINDOWS = 0
UNMAP_TOO_SHORT = 1
UNMAP_TOO_MANY_MM = 2
UNMAP_MULTIMAP = 3
UNMAP_MATE = 4

# mapMarker values (reference: IncludeDefine.h:217-226)
MARKER_ALL_PIECES_EXCEED_seedMultimapNmax = 999901
MARKER_NO_UNIQUE_PIECES = 999902
MARKER_NO_GOOD_WINDOW = 999903
MARKER_NO_GOOD_PIECES = 999904
MARKER_TOO_MANY_ANCHORS_PER_WINDOW = 999905
MARKER_READ_TOO_SHORT = 999910

NT_CHARS = "ACGT"
NUM_TO_NT = "ACGTN "  # index 5 (spacer) should never be emitted

COMPLEMENT = (3, 2, 1, 0, 4, 5)


_ENCODE_LUT = None


def _encode_lut():
    global _ENCODE_LUT
    if _ENCODE_LUT is None:
        import numpy as np
        lut = np.full(256, N_BASE, dtype=np.int8)
        for i, ch in enumerate("ACGT"):
            lut[ord(ch)] = i
            lut[ord(ch.lower())] = i
        _ENCODE_LUT = lut
    return _ENCODE_LUT


def encode_seq(s: str):
    """ASCII sequence -> numeric codes (anything non-ACGT -> N)."""
    import numpy as np
    a = np.frombuffer(s.encode(), dtype=np.uint8)
    return _encode_lut()[a]


def decode_seq(codes) -> str:
    import numpy as np
    lut = np.frombuffer(b"ACGTN ", dtype=np.uint8)
    return bytes(lut[np.asarray(codes, dtype=np.int8)]).decode()
