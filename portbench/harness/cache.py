"""The benchmark's caches inside the checkout (portbench/cache/, git-ignored):
a genome file's sequence, annotation and model, and the aligner's index of
it, each built once in a checkout at a fixed path named by a hash of what it
is made from, and then only read.  A build goes into a sibling directory
and is renamed into place when it is whole, so a run that was cut leaves
nothing that a later run would take for finished."""
from __future__ import annotations

import hashlib
import json
import os
import shutil

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(*parts) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(p if isinstance(p, bytes) else json.dumps(p, sort_keys=True).encode())
    return h.hexdigest()[:12]


def _build_into(final: str, build) -> str:
    if os.path.isdir(final):
        return final
    os.makedirs(os.path.dirname(final), exist_ok=True)
    part = final + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    build(part)
    os.replace(part, final)
    return final


def genome_dir(name: str, pb: str = PB) -> str:
    """the built genome of <pb>/genomes/<name>.json"""
    from . import genome
    spec_path = os.path.join(pb, "genomes", name + ".json")
    with open(spec_path, "rb") as f:
        spec_bytes = f.read()
    with open(genome.__file__, "rb") as f:
        code = f.read()
    final = os.path.join(pb, "cache",
                         f"genome-{name}-{_digest(spec_bytes, code)}")
    return _build_into(final, lambda d: genome.build(json.loads(spec_bytes), d))


def index_dir(gdir: str, index_flags, pb: str = PB) -> str:
    """the aligner's index of a built genome, made by its own genomeGenerate
    with the annotation inserted (as ENCODE and Cell Ranger references are
    built)"""
    final = os.path.join(pb, "cache", "index-" + _digest(
        os.path.basename(gdir), list(index_flags)))

    def build(d):
        from star_tpu_torch.run import main
        os.makedirs(d)
        main(["--runMode", "genomeGenerate", "--genomeDir", d,
              "--genomeFastaFiles", os.path.join(gdir, "genome.fa"),
              "--sjdbGTFfile", os.path.join(gdir, "annot.gtf"),
              "--outFileNamePrefix", os.path.join(d, "build_"),
              *index_flags])
    return _build_into(final, build)
