"""Port copy of hal_tpu/storage/hdf5_driver.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Reference-compatible HDF5 HAL driver (read + write) via h5py.

File layout matches the reference's HDF5 driver so .hal files interoperate
both ways (studied from reference api/hdf5_impl/):

  /Meta            group; alignment metadata as vlen-string attributes
                   (hdf5MetaData.cpp)
  /Phylogeny       group; newick tree in attribute "Phylogeny"
                   (hdf5Alignment.cpp:36-39,584-607)
  /Verison         group (sic — the typo is part of the format); version
                   string in attribute "Verison"
  /Genomes/<name>  one group per genome (hdf5Genome.cpp:29-33):
      DNA_ARRAY      uint8, ceil(len/2), nibble-packed
      TOP_ARRAY      compound {genomeIdx:i8, bottomIdx:i8, paralogyIdx:i8,
                     parentIdx:i8, reverseFlag:i1}, numTop+1 rows — the
                     sentinel row's genomeIdx is the end coordinate
                     (hdf5TopSegment.cpp:19-31)
      BOTTOM_ARRAY   compound {genomeIdx:i8, length:u8, topIdx:i8,
                     childIndexes: (childIdx:i8, reverseFlag:i1)[n]},
                     numBottom+1 rows (hdf5BottomSegment.cpp:30-94)
      SEQIDX_ARRAY   compound {start:u8, topSegmentArrayIndexOffset:u8,
                     bottomSegmentArrayIndexOffset:u8}, numSeq+1 rows
                     (hdf5Sequence.cpp:25-45)
      SEQNAME_ARRAY  fixed-length strings, numSeq rows
      Meta/          genome metadata attributes
      Rup/           attribute "Rup" = "1" when genome length is odd
                     (hdf5Genome.cpp:58-62,117-122)
"""

from __future__ import annotations

import os

import numpy as np

from hal_tpu_torch.constants import HAL_VERSION, NULL_INDEX
from hal_tpu_torch.alignment import Alignment
from hal_tpu_torch.genome import GenomeArrays
from hal_tpu_torch.tree import Tree

TOP_DTYPE = np.dtype(
    [("genomeIdx", "<i8"), ("bottomIdx", "<i8"), ("paralogyIdx", "<i8"),
     ("parentIdx", "<i8"), ("reverseFlag", "i1")]
)
SEQIDX_DTYPE = np.dtype(
    [("start", "<u8"), ("topSegmentArrayIndexOffset", "<u8"),
     ("bottomSegmentArrayIndexOffset", "<u8")]
)
CHILD_DTYPE = np.dtype([("childIdx", "<i8"), ("reverseFlag", "i1")])


def bottom_dtype(num_children: int) -> np.dtype:
    fields = [("genomeIdx", "<i8"), ("length", "<u8"), ("topIdx", "<i8")]
    if num_children > 0:
        fields.append(("childIndexes", CHILD_DTYPE, (num_children,)))
    return np.dtype(fields)


def _str_attrs(obj) -> dict[str, str]:
    out = {}
    for k, v in obj.attrs.items():
        if isinstance(v, bytes):
            v = v.decode()
        out[str(k)] = str(v)
    return out


def _write_str_attrs(group, d: dict[str, str]) -> None:
    import h5py

    st = h5py.string_dtype(encoding="ascii")
    for k, v in d.items():
        group.attrs.create(k, str(v), dtype=st)


# ---------------------------------------------------------------------- load

def _open_relaxed(path: str):
    """Open an HDF5 file read-only with relaxed file-integrity checks.

    Old reference-produced files (e.g. v2.1 paf/tests/input/mr.hal) store
    sequence names as an N-byte integer type with 8-bit precision
    (hdf5Sequence.cpp fixed-width name strings); HDF5 >= 1.14.4 rejects that
    datatype unless H5Pset_relax_file_integrity_checks is applied to the
    file-access property list.  h5py does not wrap the call, so we reach the
    C symbol via ctypes; when unavailable we fall back to a plain open.
    Accepts a file-like object (e.g. storage.remote.BlockFile) as well:
    h5py opens it directly, giving block-granular remote reads.
    """
    import h5py

    if not isinstance(path, (str, bytes, os.PathLike)):
        return h5py.File(path, "r")

    try:
        import ctypes
        import glob

        import h5py.h5f as h5f
        import h5py.h5p as h5p

        # the HDF5 library bundled beside the installed h5py package
        libs = glob.glob(os.path.join(
            os.path.dirname(os.path.dirname(h5py.__file__)), "h5py.libs",
            "libhdf5-*.so*")) or ["libhdf5.so"]
        lib = ctypes.CDLL(libs[0])
        fn = lib.H5Pset_relax_file_integrity_checks
        fn.argtypes = [ctypes.c_int64, ctypes.c_uint64]
        fn.restype = ctypes.c_int
        fapl = h5p.create(h5p.FILE_ACCESS)
        fn(fapl.id, 1)  # H5F_RFIC_UNUSUAL_NUM_UNUSED_NUMERIC_BITS
        fid = h5f.open(path.encode(), h5f.ACC_RDONLY, fapl=fapl)
        return h5py.File(fid)
    except (OSError, AttributeError):
        return h5py.File(path, "r")


def _read_seqnames(grp) -> list[str]:
    """Read SEQNAME_ARRAY, tolerating the legacy fixed-width int name type."""
    import h5py.h5s as h5s

    ds = grp["SEQNAME_ARRAY"]
    try:
        raw = ds[:]
    except TypeError:
        # legacy N-byte integer type numpy can't express: raw byte read
        did = ds.id
        ftype = did.get_type()
        n = did.get_space().get_simple_extent_npoints()
        raw = np.zeros(n, dtype="V%d" % ftype.get_size())
        did.read(h5s.ALL, h5s.ALL, raw, mtype=ftype)
        return [bytes(x).split(b"\x00", 1)[0].decode() for x in raw]
    return [
        bytes(x).split(b"\x00", 1)[0].decode()
        if isinstance(x, (bytes, np.bytes_, np.void))
        else str(x)
        for x in raw
    ]


def load(path: str) -> Alignment:
    f = _open_relaxed(path)
    aln = Alignment(path=path if isinstance(path, str) else None)
    # tree
    tree_str = ""
    if "Phylogeny" in f:
        tree_str = _str_attrs(f["Phylogeny"]).get("Phylogeny", "")
    aln.tree = Tree.from_newick(tree_str) if tree_str else Tree()
    if "Meta" in f:
        aln.metadata = _str_attrs(f["Meta"])
    if "Verison" in f:
        aln.version = _str_attrs(f["Verison"]).get("Verison", HAL_VERSION)

    def loader(name: str) -> GenomeArrays:
        return _load_genome(f, name, aln)

    aln._loader = loader
    return aln


def _load_genome(f, name: str, aln: Alignment) -> GenomeArrays:
    # current layout: /Genomes/<name>; legacy (<= v2.1, e.g. mr.hal):
    # genome groups live at the file root (hdf5Alignment.cpp genome paths)
    if "Genomes" in f and name in f["Genomes"]:
        grp = f["Genomes"][name]
    else:
        grp = f[name]
    g = GenomeArrays(name=name)

    dna = np.asarray(grp["DNA_ARRAY"][:], dtype=np.uint8) if "DNA_ARRAY" in grp else np.zeros(0, np.uint8)
    rup = False
    if "Rup" in grp:
        rup = _str_attrs(grp["Rup"]).get("Rup", "0") == "1"
    total_len = dna.size * 2 - (1 if rup else 0)

    # sequences
    if "SEQIDX_ARRAY" in grp:
        seqidx = grp["SEQIDX_ARRAY"][:]
        g.seq_names = _read_seqnames(grp)
        n_seq = len(g.seq_names)
        g.seq_start = seqidx["start"][: n_seq + 1].astype(np.int64)
        g.seq_top = seqidx["topSegmentArrayIndexOffset"][: n_seq + 1].astype(np.int64)
        g.seq_bot = seqidx["bottomSegmentArrayIndexOffset"][: n_seq + 1].astype(np.int64)
        if dna.size == 0:
            total_len = int(g.seq_start[-1])
    else:
        g.seq_names = []
        g.seq_start = np.zeros(1, np.int64)
        g.seq_top = np.zeros(1, np.int64)
        g.seq_bot = np.zeros(1, np.int64)
    g.dna = dna

    # tops
    if "TOP_ARRAY" in grp and grp["TOP_ARRAY"].shape[0] > 0:
        tops = grp["TOP_ARRAY"][:]
        n_top = len(tops) - 1
        g.top_start = tops["genomeIdx"].astype(np.int64)
        g.top_start[-1] = total_len
        g.top_parent = tops["parentIdx"][:n_top].astype(np.int64)
        g.top_parent_reversed = (tops["reverseFlag"][:n_top] != 0).astype(np.uint8)
        g.top_bottom_parse = tops["bottomIdx"][:n_top].astype(np.int64)
        g.top_paralogy = tops["paralogyIdx"][:n_top].astype(np.int64)
    else:
        g.top_start = np.array([total_len], np.int64)
        g.top_parent = np.zeros(0, np.int64)
        g.top_parent_reversed = np.zeros(0, np.uint8)
        g.top_bottom_parse = np.zeros(0, np.int64)
        g.top_paralogy = np.zeros(0, np.int64)
    if g.num_top_segments == 0:
        g.top_start = np.array([total_len], np.int64)

    # bottoms
    n_children = len(aln.tree.children(name)) if name in aln.tree else 0
    if "BOTTOM_ARRAY" in grp and grp["BOTTOM_ARRAY"].shape[0] > 0:
        bots = grp["BOTTOM_ARRAY"][:]
        n_bot = len(bots) - 1
        fields = bots.dtype.names or ()
        if "childIndexes" in fields:
            nc = bots.dtype["childIndexes"].shape[0]
        else:
            # legacy flat layout (<= v2.1): childIdx0/reverseFlag0, ...
            nc = sum(1 for fld in fields if fld.startswith("childIdx"))
        g.bot_start = np.empty(n_bot + 1, np.int64)
        g.bot_start[:-1] = bots["genomeIdx"][:n_bot].astype(np.int64)
        g.bot_start[-1] = total_len
        g.bot_top_parse = bots["topIdx"][:n_bot].astype(np.int64)
        if nc and "childIndexes" in fields:
            g.bot_child = bots["childIndexes"]["childIdx"][:n_bot].astype(np.int64).reshape(n_bot, nc)
            g.bot_child_reversed = (bots["childIndexes"]["reverseFlag"][:n_bot] != 0).astype(np.uint8).reshape(n_bot, nc)
        elif nc:
            g.bot_child = np.stack(
                [bots["childIdx%d" % j][:n_bot].astype(np.int64) for j in range(nc)], axis=1
            )
            g.bot_child_reversed = np.stack(
                [(bots["reverseFlag%d" % j][:n_bot] != 0).astype(np.uint8) for j in range(nc)], axis=1
            )
        else:
            g.bot_child = np.zeros((n_bot, 0), np.int64)
            g.bot_child_reversed = np.zeros((n_bot, 0), np.uint8)
    else:
        g.bot_start = np.array([total_len], np.int64)
        g.bot_top_parse = np.zeros(0, np.int64)
        g.bot_child = np.zeros((0, n_children), np.int64)
        g.bot_child_reversed = np.zeros((0, n_children), np.uint8)

    if "Meta" in grp:
        g.metadata = _str_attrs(grp["Meta"])
    return g


# ---------------------------------------------------------------------- save

def save(aln: Alignment, path: str, chunk: int = 1000, compression: int = 2) -> None:
    """Write a reference-compatible .hal file.

    Defaults match the reference's --hdf5Chunk 1000 / --hdf5Compression 2
    (README.md:174-180).
    """
    import h5py

    with h5py.File(path, "w") as f:
        meta = f.create_group("Meta")
        _write_str_attrs(meta, aln.metadata)
        phylo = f.create_group("Phylogeny")
        _write_str_attrs(phylo, {"Phylogeny": aln.get_newick_tree()})
        ver = f.create_group("Verison")
        _write_str_attrs(ver, {"Verison": aln.version or HAL_VERSION})
        genomes = f.create_group("Genomes")
        for name in aln.genome_names():
            _save_genome(genomes, aln.open_genome(name), chunk, compression)


def _save_genome(genomes_grp, g: GenomeArrays, chunk: int, compression: int) -> None:
    import h5py

    grp = genomes_grp.create_group(g.name)
    kw = {}
    if compression:
        kw = dict(compression="gzip", compression_opts=compression)

    def chunks(n, itemsize=1):
        if n <= 0:
            return None
        return (min(chunk, n),)

    total = g.length
    if g.dna.size:
        grp.create_dataset("DNA_ARRAY", data=g.dna, chunks=chunks(g.dna.size), **(kw if g.dna.size else {}))
    rup = grp.create_group("Rup")
    _write_str_attrs(rup, {"Rup": "1" if total % 2 else "0"})
    meta = grp.create_group("Meta")
    _write_str_attrs(meta, g.metadata)

    n_seq = g.num_sequences
    seqidx = np.zeros(n_seq + 1, SEQIDX_DTYPE)
    seqidx["start"] = g.seq_start.astype(np.uint64)
    seqidx["topSegmentArrayIndexOffset"] = g.seq_top.astype(np.uint64)
    seqidx["bottomSegmentArrayIndexOffset"] = g.seq_bot.astype(np.uint64)
    grp.create_dataset("SEQIDX_ARRAY", data=seqidx, chunks=chunks(n_seq + 1), **kw)
    max_name = max([len(s) for s in g.seq_names], default=0)
    name_dt = "S%d" % (max_name + 2)
    grp.create_dataset(
        "SEQNAME_ARRAY",
        data=np.array([s.encode() for s in g.seq_names], dtype=name_dt) if n_seq else np.zeros(0, name_dt),
        chunks=chunks(n_seq),
        **(kw if n_seq else {}),
    )

    n_top = g.num_top_segments
    tops = np.zeros(n_top + 1, TOP_DTYPE)
    tops["genomeIdx"] = g.top_start
    tops["bottomIdx"][:n_top] = g.top_bottom_parse
    tops["paralogyIdx"][:n_top] = g.top_paralogy
    tops["parentIdx"][:n_top] = g.top_parent
    tops["reverseFlag"][:n_top] = g.top_parent_reversed
    tops["bottomIdx"][n_top] = NULL_INDEX
    tops["paralogyIdx"][n_top] = NULL_INDEX
    tops["parentIdx"][n_top] = NULL_INDEX
    grp.create_dataset("TOP_ARRAY", data=tops, chunks=chunks(n_top + 1), **kw)

    n_bot = g.num_bottom_segments
    bdt = bottom_dtype(g.num_children)
    bots = np.zeros(n_bot + 1, bdt)
    bots["genomeIdx"][:n_bot] = g.bot_start[:-1]
    bots["genomeIdx"][n_bot] = total
    bots["length"][:n_bot] = np.diff(g.bot_start).astype(np.uint64)
    bots["topIdx"][:n_bot] = g.bot_top_parse
    bots["topIdx"][n_bot] = NULL_INDEX
    if g.num_children:
        bots["childIndexes"]["childIdx"][:n_bot] = g.bot_child
        bots["childIndexes"]["reverseFlag"][:n_bot] = g.bot_child_reversed
        bots["childIndexes"]["childIdx"][n_bot] = NULL_INDEX
    grp.create_dataset("BOTTOM_ARRAY", data=bots, chunks=chunks(n_bot + 1), **kw)
