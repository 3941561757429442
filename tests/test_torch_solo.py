"""STARsolo through star_tpu_torch against the STAR goldens: CB_UMI_Simple
(every UMI dedup type, multimappers, MultiGeneUMI filters, EmptyDrops_CR,
multi-feature runs, CB/UB BAM tags, Transcript3p), CB_UMI_Complex, SmartSeq
and CB_samTagOut, on the host oracle, on the device path on CPU tensors
(the seed loop must run there) and with the device stitch engine forced on
every level (batch_engine.fast_path_config_ok admits every solo config);
and --runMode soloCellFiltering through the port's main.  Exact equality
throughout: Solo.out trees file by file, BAMs record for record.  The cases
are those of chip_smoke.SOLO_GOLDENS, which phase 7 runs on the card."""
import os
from unittest import mock

import pytest

import chip_smoke as cs
from star_tpu_torch.align import clip
from star_tpu_torch.ops import batch_engine as be
from star_tpu_torch.ops import pipeline
from star_tpu_torch.params import Parameters
from star_tpu_torch.run import align_reads
from tests.test_torch_stitch import force_device_grow, one_torch_thread  # noqa: F401

GOLDENS = os.path.join(cs.TESTS, "golden")


@pytest.fixture(scope="module")
def ed_index(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("solo_ed_idx"))
    cs.solo_ed_index(out)
    return out


def run_solo(prefix, index, flags, engine, batch=None):
    """map a solo case through star_tpu_torch.run.align_reads; engine as in
    test_torch_chimeric.run_port.  Returns the device path's LEVEL_STATS"""
    P = Parameters(["--genomeDir", index, "--outFileNamePrefix", prefix,
                    *flags, *(["--tpuBatchSize", str(batch)] if batch else [])])
    if engine == "host":
        align_reads(P, use_device=False)
        return {}
    real = pipeline.DeviceAligner._run_chains_fused
    be.LEVEL_STATS.clear()
    with mock.patch.object(pipeline.DeviceAligner, "_run_chains_fused",
                           autospec=True, side_effect=real) as seed_loop:
        align_reads(P, device="cpu")
    assert seed_loop.call_count > 0
    if engine == "forced":
        assert sum(v for (w, k), v in be.LEVEL_STATS.items()
                   if k == "device") > 0
    return dict(be.LEVEL_STATS)


@pytest.fixture(params=["host", "device", "forced"])
def engine(request):
    if request.param == "forced":
        request.getfixturevalue("force_device_grow")
    return request.param


@pytest.mark.parametrize("case,gold,index,flags,files", cs.SOLO_GOLDENS,
                         ids=[c[0] for c in cs.SOLO_GOLDENS])
def test_solo_golden(tmp_path, ed_index, case, gold, index, flags, files,
                     engine):
    prefix = str(tmp_path) + "/"
    run_solo(prefix, ed_index if index == cs.SOLO_ED_INDEX else index, flags,
             engine)
    assert cs.solo_diff(prefix, os.path.join(GOLDENS, gold), files) == []


def test_solo_batch_boundaries(tmp_path, force_device_grow):
    """the solo golden in six batches of 512 reads with the engine forced:
    the barcodes wait on a deque for the reads in flight, so every batch
    boundary must keep each read with its own barcode"""
    case, gold, index, flags, files = cs.SOLO_GOLDENS[0]
    prefix = str(tmp_path) + "/"
    stats = run_solo(prefix, index, flags, "forced", batch=512)
    assert stats[8, "runs"] == 6 and stats[8, "device"] == 6
    assert cs.solo_diff(prefix, os.path.join(GOLDENS, gold), files) == []


def test_solo_barcode_paired_with_its_read(tmp_path):
    """a read the device path returns out of input order would take another
    read's barcode: the reader stops the run instead"""
    case, gold, index, flags, files = cs.SOLO_GOLDENS[0]
    real = pipeline.DeviceAligner.align_stream

    def swapped(self, reader, stats):
        out = list(real(self, reader, stats))
        out[1], out[2] = out[2], out[1]
        yield from out
    P = Parameters(["--genomeDir", index, "--outFileNamePrefix",
                    str(tmp_path) + "/", *flags, "--readMapNumber", "8"])
    with mock.patch.object(pipeline.DeviceAligner, "align_stream", swapped):
        with pytest.raises(RuntimeError, match="paired with read"):
            align_reads(P, device="cpu")


def test_device_reader_numbers_reads_as_the_host(tmp_path):
    """SmartSeq takes the plain reader: the device path numbers its reads
    (i_read_all, read by the solo read index and the BAM sort key) in input
    order, as the host oracle does"""
    from star_tpu_torch.solo.solo import Solo
    case, gold, index, flags, files = next(c for c in cs.SOLO_GOLDENS
                                           if c[0] == "smartseq")
    seen = {}
    real = Solo.add_read
    for engine in ("host", "device"):
        seen[engine] = []

        def spy(self, res, b_seq, b_qual, i_read, _l=seen[engine]):
            _l.append((res.name, i_read, res.read_file_index))
            return real(self, res, b_seq, b_qual, i_read)
        with mock.patch.object(Solo, "add_read", spy):
            run_solo(str(tmp_path / engine) + "/", index, flags, engine)
    assert len(seen["host"]) > 100
    assert seen["device"] == seen["host"]
    assert [i for _, i, _ in seen["host"]] == list(range(len(seen["host"])))


def test_solo_cell_filtering_runmode(tmp_path):
    """--runMode soloCellFiltering through the port's main: re-filter
    solo3/mgumi's raw matrix with EmptyDrops_CR, including the reference's
    nCB off-by-one that drops the last-indexed cell"""
    assert cs.solo_cellfilt(str(tmp_path) + "/") == []


def cr4_reads(rng, n):
    """reads of 0-130 bases, 2 % N, most starting with a TSO fragment
    (4 % substitutions, some with a base deleted, at offsets 0-3) and a
    third ending in a polyA tail"""
    tso = clip.CR4_TSO
    seqs = []
    for i in range(n):
        body = "".join("ACGTN"[j] for j in rng.choice(
            5, 130, p=[.245, .245, .245, .245, .02]))
        if i % 3:
            frag = list(tso[int(rng.integers(0, 20)):])
            for k in range(len(frag)):
                if rng.random() < 0.04:
                    frag[k] = "ACGTN"[int(rng.integers(0, 5))]
            if i % 5 == 0:
                del frag[int(rng.integers(0, len(frag)))]
            body = body[:int(rng.integers(0, 4))] + "".join(frag) + body
        body = body[:int(rng.integers(0, 131))]
        if i % 3 == 1:
            body = body[:max(0, len(body) - int(rng.integers(10, 40)))]
            body += "A" * (130 - len(body))
            body = body[:int(rng.integers(len(body) // 2, len(body) + 1))]
        seqs.append(body)
    return seqs


@pytest.mark.parametrize("n5", [0, 3])
def test_cr4_clip_of_a_batch_equals_per_read(n5):
    """prepare_read with --clipAdapterType CellRanger4 gives the same clips
    and read when its 5p ClipMate was given the batch first
    (ReadAligner.clip_batch, the device path's prepare: the TSO clip of all
    reads at once) as read by read (the host oracle's); in the batched
    pass no read falls back to the per-read DP"""
    import numpy as np
    from star_tpu_torch.genome.index import GenomeIndex
    from star_tpu_torch.align.engine import ReadAligner
    gi = GenomeIndex.load(os.path.join(GOLDENS, "small", "genome_idx"))
    P = Parameters(["--clipAdapterType", "CellRanger4",
                    "--clip5pNbases", str(n5)])
    seqs = cr4_reads(np.random.default_rng(4), 1500)

    def prepared(aligner):
        out = []
        for k, s in enumerate(seqs):
            res, reads = aligner.prepare_read(f"r{k}", [s], ["F" * len(s)])
            out.append((res.clips, res.read_length, reads[0].tobytes()))
        return out
    want = prepared(ReadAligner(gi, P))
    batched = ReadAligner(gi, P)
    batched.clip_batch([[s] for s in seqs])
    with mock.patch.object(clip, "cr4_clip5p_info",
                           side_effect=AssertionError("per-read DP")):
        got = prepared(batched)
    assert got == want
    assert sum(1 for c, _, _ in want if c[0][0] > n5) > 200
    assert sum(1 for c, _, _ in want if c[0][1] > 0) > 200


@pytest.mark.parametrize("target", ["missing", "elsewhere"])
def test_golden_link_read_in_any_checkout(tmp_path, tmp_path_factory,
                                          target):
    """solo_feat's golden Solo.out/SJ/raw/features.tsv links to its run's
    SJ.out.tab by an absolute path into the checkout the goldens were made
    in; whether that path is missing or names another checkout's file,
    the comparison reads the same golden file in this checkout"""
    rel = os.path.join("small", "solo_feat", "SJ.out.tab")
    want = open(os.path.join(GOLDENS, rel), "rb").read()
    if target == "missing":
        link = os.path.join("/nonexistent", "tests", "golden", rel)
    else:
        link = str(tmp_path_factory.mktemp("other") / "tests" / "golden" / rel)
        os.makedirs(os.path.dirname(link))
        open(link, "wb").write(b"another checkout's file\n")
    gold = tmp_path / "gold" / "SJ" / "raw"
    gold.mkdir(parents=True)
    (gold / "features.tsv").symlink_to(link)
    out = tmp_path / "out" / "SJ" / "raw"
    out.mkdir(parents=True)
    (out / "features.tsv").write_bytes(want)
    assert cs.tree_diff(str(tmp_path / "out"), str(tmp_path / "gold")) == []
    for wrong in (want + b"x", b"another checkout's file\n"):
        (out / "features.tsv").write_bytes(wrong)
        assert cs.tree_diff(str(tmp_path / "out"),
                            str(tmp_path / "gold")) == ["SJ/raw/features.tsv"]
