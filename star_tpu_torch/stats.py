"""Run statistics and Log.final.out report.

Format matches the reference summary byte-for-byte modulo timestamps
(reference: source/Stats.cpp reportFinal/transcriptStats).
"""
from __future__ import annotations

import time


def _ts(t: float) -> str:
    return time.strftime("%b %d %H:%M:%S", time.localtime(t))


class RunStats:
    def __init__(self):
        self.time_start = time.time()
        self.time_start_map = self.time_start
        self.time_end_map = self.time_start
        self.read_n = 0
        self.read_bases = 0
        self.mapped_reads_u = 0
        self.mapped_reads_m = 0
        self.mapped_bases = 0
        self.mapped_mm = 0
        self.mapped_ins_n = 0
        self.mapped_ins_l = 0
        self.mapped_del_n = 0
        self.mapped_del_l = 0
        self.splices_n = [0] * 7
        self.splices_sjdb = 0
        self.unmapped_multi = 0
        self.unmapped_short = 0
        self.unmapped_mm = 0
        self.unmapped_other = 0
        self.chimeric_all = 0

    def add_read(self, res):
        self.read_n += 1
        self.read_bases += sum(len(s) for s in res.seqs)
        if self._progress is not None and (self.read_n & 1023) == 0:
            self._progress_report()

    # ---- Log.progress.out (reference: Stats.cpp progressReport, 60 s gate)
    _progress = None
    _time_last_report = 0.0

    def open_progress(self, path: str):
        try:
            self._progress = open(path, "w")
        except OSError:
            self._progress = None
            return
        w = ("Time".rjust(15) + "Speed".rjust(9) + "Read".rjust(12)
             + "Read".rjust(9) + "Mapped".rjust(9) + "Mapped".rjust(9)
             + "Mapped".rjust(9) + "Mapped".rjust(9) + "Unmapped".rjust(9)
             + "Unmapped".rjust(9) + "Unmapped".rjust(9) + "Unmapped".rjust(9))
        w2 = (" ".rjust(15) + "M/hr".rjust(9) + "number".rjust(12)
              + "length".rjust(9) + "unique".rjust(9) + "length".rjust(9)
              + "MMrate".rjust(9) + "multi".rjust(9) + "multi+".rjust(9)
              + "MM".rjust(9) + "short".rjust(9) + "other".rjust(9))
        self._progress.write(w + "\n" + w2 + "\n")
        self._progress.flush()
        self._time_last_report = time.time()

    def _progress_report(self, force=False):
        now = time.time()
        if not force and now - self._time_last_report < 60.0:
            return
        self._time_last_report = now
        n = self.read_n
        dt = max(now - self.time_start_map, 1e-9)
        pct = lambda x: f"{(x / n * 100 if n else 0):.1f}%"
        row = (_ts(now).rjust(15)
               + f"{n / 1e6 / dt * 3600:.1f}".rjust(9)
               + str(n).rjust(12)
               + str(self.read_bases // n if n else 0).rjust(9)
               + pct(self.mapped_reads_u).rjust(9)
               + f"{(self.mapped_bases / self.mapped_reads_u if self.mapped_reads_u else 0):.1f}".rjust(9)
               + (f"{(self.mapped_mm / self.mapped_bases * 100 if self.mapped_bases else 0):.1f}%").rjust(9)
               + pct(self.mapped_reads_m).rjust(9)
               + pct(self.unmapped_multi).rjust(9)
               + pct(self.unmapped_mm).rjust(9)
               + pct(self.unmapped_short).rjust(9)
               + pct(self.unmapped_other).rjust(9))
        self._progress.write(row + "\n")
        self._progress.flush()

    def close_progress(self):
        if self._progress is not None:
            self._progress_report(force=True)
            self._progress.close()
            self._progress = None

    def add_mapped(self, res, override=None):
        """override=(transcripts, n_tr): STARconsensus counts the CONVERTED
        alignment set (reference ReadAlign_outputAlignments.cpp:25-36)"""
        trs, n_tr = override if override is not None \
            else (res.transcripts, res.n_tr)
        if n_tr > 1:
            self.mapped_reads_m += 1
        elif n_tr == 1:
            self.mapped_reads_u += 1
            tr = trs[0]
            self.mapped_mm += tr.nMM
            self.mapped_ins_n += tr.nIns
            self.mapped_del_n += tr.nDel
            self.mapped_ins_l += tr.lIns
            self.mapped_del_l += tr.lDel
            self.mapped_bases += sum(e[2] for e in tr.exons)
            for ii in range(tr.nExons - 1):
                if tr.canonSJ[ii] >= 0:
                    self.splices_n[tr.canonSJ[ii]] += 1
                if tr.sjAnnot[ii] == 1:
                    self.splices_sjdb += 1

    def add_unmapped(self, res):
        u = res.unmap_type
        if u == 0:
            self.unmapped_other += 1
        elif u == 1:
            self.unmapped_short += 1
        elif u == 2:
            self.unmapped_mm += 1
        elif u == 3:
            self.unmapped_multi += 1

    # ------------------------------------------------------------------ report
    def report_final(self) -> str:
        w1 = 50
        n = self.read_n
        mb = self.mapped_bases
        dt = max(self.time_end_map - self.time_start_map, 1e-9)

        def row(label, value):
            return f"{label + ' |':>{w1 - 1}}\t{value}\n"

        def pct(x, d):
            return f"{(100.0 * x / d if d > 0 else 0):.2f}%"

        out = []
        out.append(row("Started job on", _ts(self.time_start)))
        out.append(row("Started mapping on", _ts(self.time_start_map)))
        out.append(row("Finished on", _ts(self.time_end_map)))
        out.append(row("Mapping speed, Million of reads per hour",
                       f"{n / 1e6 / dt * 3600:.2f}"))
        out.append("\n")
        out.append(row("Number of input reads", n))
        out.append(row("Average input read length", self.read_bases // n if n else 0))
        out.append(f"{'UNIQUE READS:':>{w1 - 37}}\n".rjust(0))
        out[-1] = " " * 36 + "UNIQUE READS:\n"
        out.append(row("Uniquely mapped reads number", self.mapped_reads_u))
        out.append(row("Uniquely mapped reads %", pct(self.mapped_reads_u, n)))
        out.append(row("Average mapped length",
                       f"{(mb / self.mapped_reads_u if self.mapped_reads_u else 0):.2f}"))
        out.append(row("Number of splices: Total", sum(self.splices_n)))
        out.append(row("Number of splices: Annotated (sjdb)", self.splices_sjdb))
        out.append(row("Number of splices: GT/AG", self.splices_n[1] + self.splices_n[2]))
        out.append(row("Number of splices: GC/AG", self.splices_n[3] + self.splices_n[4]))
        out.append(row("Number of splices: AT/AC", self.splices_n[5] + self.splices_n[6]))
        out.append(row("Number of splices: Non-canonical", self.splices_n[0]))
        out.append(row("Mismatch rate per base, %", pct(self.mapped_mm, mb)))
        out.append(row("Deletion rate per base", pct(self.mapped_del_l, mb)))
        out.append(row("Deletion average length",
                       f"{(self.mapped_del_l / self.mapped_del_n if self.mapped_del_n else 0):.2f}"))
        out.append(row("Insertion rate per base", pct(self.mapped_ins_l, mb)))
        out.append(row("Insertion average length",
                       f"{(self.mapped_ins_l / self.mapped_ins_n if self.mapped_ins_n else 0):.2f}"))
        out.append(" " * 29 + "MULTI-MAPPING READS:\n")
        out.append(row("Number of reads mapped to multiple loci", self.mapped_reads_m))
        out.append(row("% of reads mapped to multiple loci", pct(self.mapped_reads_m, n)))
        out.append(row("Number of reads mapped to too many loci", self.unmapped_multi))
        out.append(row("% of reads mapped to too many loci", pct(self.unmapped_multi, n)))
        out.append(" " * 34 + "UNMAPPED READS:\n")
        out.append(row("Number of reads unmapped: too many mismatches", self.unmapped_mm))
        out.append(row("% of reads unmapped: too many mismatches", pct(self.unmapped_mm, n)))
        out.append(row("Number of reads unmapped: too short", self.unmapped_short))
        out.append(row("% of reads unmapped: too short", pct(self.unmapped_short, n)))
        out.append(row("Number of reads unmapped: other", self.unmapped_other))
        out.append(row("% of reads unmapped: other", pct(self.unmapped_other, n)))
        out.append(" " * 34 + "CHIMERIC READS:\n")
        out.append(row("Number of chimeric reads", self.chimeric_all))
        out.append(row("% of chimeric reads", pct(self.chimeric_all, n)))
        return "".join(out)
