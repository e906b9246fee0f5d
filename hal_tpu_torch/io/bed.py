"""Port copy of hal_tpu/io/bed.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

BED3-12(+extra) and PSL records.

Parse/serialize matching the reference byte-for-byte
(reference liftover/impl/halBedLine.cpp: read :27-103, write :104-150,
writePSL :206-249, expandToBed12 :152-186)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PSLInfo:
    """reference liftover/inc/halBedLine.h PSLInfo."""

    matches: int = 0
    mis_matches: int = 0
    rep_matches: int = 0
    n_count: int = 0
    q_num_insert: int = 0
    q_base_insert: int = 0
    t_num_insert: int = 0
    t_base_insert: int = 0
    q_strand: str = "+"
    q_seq_name: str = ""
    q_seq_size: int = 0
    q_chrom_offset: int = 0
    q_end: int = 0
    t_seq_size: int = 0
    q_block_starts: list[int] = field(default_factory=list)


@dataclass
class BedLine:
    chrom: str = ""
    start: int = 0
    end: int = 0
    bed_type: int = 3
    name: str = ""
    score: int = 0
    strand: str = "+"
    thick_start: int = 0
    thick_end: int = 0
    item_rgb: tuple[int, int, int] = (0, 0, 0)
    blocks: list[tuple[int, int]] = field(default_factory=list)  # (start, length)
    extra: list[str] = field(default_factory=list)
    # liftover bookkeeping (not serialized in BED)
    src_start: int = 0
    src_strand: str = "+"
    psl: PSLInfo | None = None

    @classmethod
    def parse(cls, line: str, bed_type: int = 0) -> "BedLine":
        row = line.rstrip("\n").split("\t")
        if len(row) < 3:
            raise ValueError("Expected at least three columns in BED record: " + line)
        bt = bed_type if bed_type else min(len(row), 12)
        b = cls(chrom=row[0], start=int(row[1]), end=int(row[2]), bed_type=bt)
        if b.start >= b.end:
            raise ValueError("Error zero or negative length BED range: " + line)
        if bt > 3:
            b.name = row[3]
        if bt > 4:
            b.score = int(row[4])
        if bt > 5:
            b.strand = row[5][0]
            if b.strand not in "+-.":
                raise ValueError("Strand character must be + or - or ." + line)
        if bt > 6:
            b.thick_start = int(row[6])
        if bt > 7:
            b.thick_end = int(row[7])
        if bt > 8:
            rgb = row[8].split(",")
            if not 1 <= len(rgb) <= 3:
                raise ValueError("Error parsing BED itemRGB: " + line)
            r = int(rgb[0])
            g = int(rgb[1]) if len(rgb) > 1 else r
            bb = int(rgb[2]) if len(rgb) == 3 else r
            b.item_rgb = (r, g, bb)
        if bt > 9:
            if bt < 12:
                raise ValueError("Error parsing BED, insufficient columns for blocks: " + line)
            n = int(row[9])
            sizes = [int(x) for x in row[10].rstrip(",").split(",")] if row[10].strip(",") else []
            starts = [int(x) for x in row[11].rstrip(",").split(",")] if row[11].strip(",") else []
            if len(sizes) != n or len(starts) != n:
                raise ValueError("Error parsing BED blockSizes/blockStarts: " + line)
            b.blocks = list(zip(starts, sizes))
        b.extra = row[min(len(row), 12):] if bt >= 12 else row[bt:]
        return b

    def expand_to_bed12(self) -> None:
        if self.bed_type <= 3:
            self.name = ""
        if self.bed_type <= 4:
            self.score = 0
        if self.bed_type <= 5:
            self.strand = "+"
        if self.bed_type <= 6:
            self.thick_start = self.start
        if self.bed_type <= 7:
            self.thick_end = self.end
        if self.bed_type <= 8:
            self.item_rgb = (0, 0, 0)
        if self.bed_type <= 9:
            self.blocks = [(0, self.end - self.start)]
        self.bed_type = 12

    def write(self) -> str:
        out = ["%s\t%d\t%d" % (self.chrom, self.start, self.end)]
        bt = self.bed_type
        if bt > 3:
            out.append("\t" + self.name)
        if bt > 4:
            out.append("\t%d" % self.score)
        if bt > 5:
            out.append("\t" + self.strand)
        if bt > 6:
            out.append("\t%d" % self.thick_start)
        if bt > 7:
            out.append("\t%d" % self.thick_end)
        if bt > 8:
            out.append("\t%d,%d,%d" % self.item_rgb)
        if bt > 9:
            out.append("\t%d" % len(self.blocks))
            out.append("\t" + ",".join("%d" % l for _, l in self.blocks))
            out.append("\t" + ",".join("%d" % s for s, _ in self.blocks))
        for e in self.extra:
            out.append("\t" + e)
        out.append("\n")
        return "".join(out)

    def write_psl(self, with_name: bool = False) -> str:
        psl = self.psl
        assert psl is not None and self.blocks
        out = []
        if with_name:
            out.append(self.name + "\t")
        out.append(
            "%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%s%s\t%s\t%d\t%d\t%d\t%s\t%d\t%d\t%d\t%d\t"
            % (psl.matches, psl.mis_matches, psl.rep_matches, psl.n_count,
               psl.q_num_insert, psl.q_base_insert, psl.t_num_insert, psl.t_base_insert,
               psl.q_strand, self.strand, psl.q_seq_name, psl.q_seq_size,
               self.src_start - psl.q_chrom_offset, psl.q_end - psl.q_chrom_offset,
               self.chrom, psl.t_seq_size, self.start, self.end, len(self.blocks)))
        out.append("".join("%d," % l for _, l in self.blocks))
        out.append("\t")
        for (s, l), q in zip(self.blocks, psl.q_block_starts):
            qs = q - psl.q_chrom_offset
            if psl.q_strand == "-":
                qs = psl.q_seq_size - qs - l
            out.append("%d," % qs)
        out.append("\t")
        for s, l in self.blocks:
            ts = s + self.start
            if self.strand == "-":
                ts = psl.t_seq_size - ts - l
            out.append("%d," % ts)
        out.append("\n")
        return "".join(out)


def read_bed(stream, bed_type: int = 0):
    """Yield BedLines, skipping comments/track lines/blanks the way
    BedScanner does (reference liftover/impl/halBedScanner.cpp)."""
    for line in stream:
        s = line.strip()
        if not s or s.startswith("#") or s.startswith("track") or s.startswith("browser"):
            continue
        yield BedLine.parse(line, bed_type)
