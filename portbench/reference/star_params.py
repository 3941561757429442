"""The STAR 2.7.11b parameters the reference judges by: the documented
defaults (STAR's parametersDefault), overridden by a configuration's flags."""
from __future__ import annotations

DEFAULTS = {
    "sjdbScore": [2], "scoreGap": [0], "scoreGapNoncan": [-8],
    "scoreGapGCAG": [-4], "scoreGapATAC": [-8], "scoreDelOpen": [-2],
    "scoreDelBase": [-2], "scoreInsOpen": [-2], "scoreInsBase": [-2],
    "scoreGenomicLengthLog2scale": [-0.25], "alignIntronMin": [21],
    "outFilterMultimapScoreRange": [1], "outFilterMultimapNmax": [10],
    "outFilterMismatchNmax": [10], "outFilterMismatchNoverReadLmax": [1.0],
    "outFilterMismatchNoverLmax": [0.3], "outFilterScoreMin": [0],
    "outFilterScoreMinOverLread": [0.66], "outFilterMatchNmin": [0],
    "outFilterMatchNminOverLread": [0.66], "outSAMmapqUnique": [255],
    "outFilterType": ["Normal"],
    "outSJfilterOverhangMin": [30, 12, 12, 12],
    "outSJfilterCountUniqueMin": [3, 1, 1, 1],
    "outSJfilterCountTotalMin": [3, 1, 1, 1],
    "outSJfilterDistToOtherSJmin": [10, 0, 5, 10],
    "outSJfilterIntronMaxVsReadN": [50000, 100000, 200000],
    "quantMode": ["-"], "outSAMtype": ["SAM"],
    "alignSJoverhangMin": [5], "alignSJDBoverhangMin": [3],
}


def parse(flags):
    """{name: [values]} from a flag list ("--name v1 v2 ..."), numbers as
    int or float, over DEFAULTS"""
    out = {k: list(v) for k, v in DEFAULTS.items()}
    name = None
    for tok in flags:
        if tok.startswith("--"):
            name = tok[2:]
            out[name] = []
        elif name is not None:
            for conv in (int, float):
                try:
                    tok = conv(tok)
                    break
                except ValueError:
                    pass
            out[name].append(tok)
    return out


class Scoring:
    def __init__(self, p):
        g = lambda k: p[k][0]
        self.sjdb = g("sjdbScore")
        self.gap = g("scoreGap")
        self.pen = {0: g("scoreGapNoncan"), 1: 0, 2: 0, 3: g("scoreGapGCAG"),
                    4: g("scoreGapGCAG"), 5: g("scoreGapATAC"),
                    6: g("scoreGapATAC")}
        self.del_open, self.del_base = g("scoreDelOpen"), g("scoreDelBase")
        self.ins_open, self.ins_base = g("scoreInsOpen"), g("scoreInsBase")
        self.log2scale = g("scoreGenomicLengthLog2scale")
        self.intron_min = g("alignIntronMin")
