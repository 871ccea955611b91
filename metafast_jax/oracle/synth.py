"""Seeded synthetic metagenomes: genomes, communities and read files.

Genomes are uniform random 2-bit code arrays (A=0, G=1, C=2, T=3, the
encoding of core/bitpack).  A sample is a community of genomes with
per-genome abundances; its reads are error-free substrings drawn in
proportion to abundance x genome length, each reverse-complemented with
probability 1/2.  Everything is a pure function of the generator passed
in, so a seed reproduces a data set exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

_ASCII = np.frombuffer(b"AGCT", dtype=np.uint8)


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    """[length] uint8 codes."""
    return rng.integers(0, 4, length, dtype=np.uint8)


def lognormal_abundances(rng: np.random.Generator, n: int,
                         sigma: float = 1.0) -> np.ndarray:
    """[n] log-normal abundances, normalised to mean 1."""
    a = np.exp(rng.normal(0.0, sigma, n))
    return a / a.mean()


def sample_reads(rng: np.random.Generator, genomes: list[np.ndarray],
                 abundances: np.ndarray, coverage: float,
                 read_len: int) -> np.ndarray:
    """[n_reads, read_len] uint8 codes at `coverage` x the community's
    total genome length."""
    lens = np.array([len(g) for g in genomes], dtype=np.int64)
    if (lens < read_len).any():
        raise ValueError("every genome must be at least one read long")
    n_reads = int(coverage * lens.sum() / read_len)
    w = np.asarray(abundances, dtype=np.float64) * lens
    which = rng.choice(len(genomes), size=n_reads, p=w / w.sum())
    offs = np.concatenate([[0], np.cumsum(lens)])
    starts = offs[which] + (rng.random(n_reads)
                            * (lens[which] - read_len + 1)).astype(np.int64)
    flat = np.concatenate(genomes)
    reads = flat[starts[:, None] + np.arange(read_len)[None, :]]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return reads


def write_fasta(path, reads: np.ndarray) -> None:
    """One '>r' record per row of [n, L] codes."""
    n, L = reads.shape
    rec = np.empty((n, L + 4), dtype=np.uint8)
    rec[:, :3] = np.frombuffer(b">r\n", dtype=np.uint8)
    rec[:, 3:L + 3] = _ASCII[reads]
    rec[:, L + 3] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())


def write_fastq(path, reads: np.ndarray, qual: int = ord("I")) -> None:
    """One '@r' record per row of [n, L] codes, constant quality."""
    n, L = reads.shape
    rec = np.empty((n, 2 * L + 7), dtype=np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", dtype=np.uint8)
    rec[:, 3:L + 3] = _ASCII[reads]
    rec[:, L + 3:L + 6] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, L + 6:2 * L + 6] = qual
    rec[:, 2 * L + 6] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())


def read_strings(reads: np.ndarray) -> list[str]:
    """Rows of [n, L] codes as ACGT strings (for the pure-Python oracle)."""
    return [r.tobytes().decode("ascii") for r in _ASCII[reads]]


def grouped_communities(rng: np.random.Generator, n_samples: int,
                        genomes_per_sample: int, genome_len: int,
                        group_size: int = 2, n_core: int = 2):
    """Per-sample genome lists.  Consecutive samples form groups of
    `group_size` that share half their genomes; `n_core` of that half
    is common to every sample, and the other half of each sample's
    genomes is its own."""
    n_shared = genomes_per_sample // 2
    if not 0 <= n_core <= n_shared:
        raise ValueError("n_core must lie in [0, genomes_per_sample // 2]")
    core = [random_genome(rng, genome_len) for _ in range(n_core)]
    out = []
    shared = None
    for s in range(n_samples):
        if s % group_size == 0:
            shared = core + [random_genome(rng, genome_len)
                             for _ in range(n_shared - n_core)]
        own = [random_genome(rng, genome_len)
               for _ in range(genomes_per_sample - n_shared)]
        out.append(shared + own)
    return out


@dataclass(frozen=True)
class Scale:
    """A multi-sample data set of grouped communities."""
    samples: int
    genomes: int          # per sample; pairs share half, two in all
    genome_len: int
    coverage: float       # mean, over the community
    sigma: float = 1.0    # log-normal abundance spread
    seed: int = 0


# ~2.55M reads of 150 bp and ~306M k-mers per sample; 27.5-29M distinct
# 31-mers per sample after b=1 (make_communities' estimate for this seed)
FULL = Scale(samples=4, genomes=29, genome_len=1_100_000, coverage=12.0)


def make_communities(scale: Scale, td, k: int = 31, read_len: int = 150,
                     keep_reads_of: int | None = 0):
    """Write one FASTA file of reads per sample of `scale` into `td`.

    Returns (files, reads of sample `keep_reads_of`, per-sample expected
    distinct k-mers seen at least twice, a Poisson estimate)."""
    rng = np.random.default_rng(scale.seed)
    comms = grouped_communities(rng, scale.samples, scale.genomes,
                                scale.genome_len)
    files, kept, expect = [], None, []
    for s, genomes in enumerate(comms):
        ab = lognormal_abundances(rng, len(genomes), scale.sigma)
        reads = sample_reads(rng, genomes, ab, scale.coverage, read_len)
        f = Path(td) / f"sample_{s}.fa"
        write_fasta(f, reads)
        files.append(str(f))
        lam = scale.coverage * ab * (read_len - k + 1) / read_len
        expect.append(scale.genome_len * float(
            (1 - np.exp(-lam) * (1 + lam)).sum()))
        if s == keep_reads_of:
            kept = reads
        del reads
    return files, kept, expect
