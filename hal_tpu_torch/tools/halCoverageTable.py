"""Port copy of hal_tpu/tools/halCoverageTable.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

halCoverageTable — tabulate halCoverage outputs across files
(reference stats/halcoverage-table.py: parses `Genome, sites...` /
`Coverage on <seq>` sections of one-or-more halCoverage runs into a
percentage/count table, with optional chromosome lumping)."""

from __future__ import annotations

import os
import sys

from hal_tpu_torch.tools import HalError, make_parser, tool_main


def parse_coverage(path: str) -> dict:
    """{section -> {species -> sites}} for one halCoverage output file.
    Sections: 'Total' (the leading table) and one per 'Coverage on <seq>'."""
    out: dict = {}
    section = None
    with open(path) as f:
        for line in f:
            if line.startswith("Genome, sites"):
                section = "Total"
                out[section] = {}
            elif line.startswith("Coverage on "):
                section = line.rstrip()[len("Coverage on "):]
                out[section] = {}
            else:
                toks = line.rstrip().replace(" ", "").split(",")
                if len(toks) > 1 and section is not None:
                    out[section][toks[0]] = int(toks[1])
    return out


def run(argv=None):
    p = make_parser("halCoverageTable", "Make a table out of halCoverage output")
    p.add_argument("--input", nargs="+", required=True,
                   help="halCoverage output files")
    p.add_argument("--reference", required=True,
                   help="reference genome used in halCoverage")
    p.add_argument("--chroms", nargs="+", default=None,
                   help="lump all chroms together except these")
    p.add_argument("--counts", action="store_true",
                   help="write counts instead of percentages")
    o = p.parse_args(argv)

    file_coverage = {}
    for path in o.input:
        name = os.path.splitext(os.path.basename(path))[0]
        if name in file_coverage:
            raise HalError("duplicate input name %s" % name)
        cov = parse_coverage(path)
        if o.chroms:
            lump: dict = {}
            keep = {}
            for sec, table in cov.items():
                if sec in ["Total"] + list(o.chroms):
                    keep[sec] = table
                else:
                    for sp, c in table.items():
                        lump[sp] = lump.get(sp, 0) + c
            keep["Chroms"] = lump
            cov = keep
        file_coverage[name] = cov

    names = sorted(file_coverage)
    sections = sorted({s for cov in file_coverage.values() for s in cov},
                      key=lambda s: (s != "Total", s))
    out = sys.stdout
    for sec in sections:
        species = sorted({sp for cov in file_coverage.values()
                          for sp in cov.get(sec, {})})
        out.write("%s\t%s\n" % (sec, "\t".join(names)))
        for sp in species:
            row = [sp]
            for name in names:
                c = file_coverage[name].get(sec, {}).get(sp)
                if c is None:
                    row.append("-")
                elif o.counts:
                    row.append(str(c))
                else:
                    ref = file_coverage[name].get(sec, {}).get(o.reference)
                    row.append("%.2f%%" % (100.0 * c / ref) if ref else "-")
            out.write("\t".join(row) + "\n")
        out.write("\n")


def main(argv=None):
    return tool_main(run, argv)


if __name__ == "__main__":
    sys.exit(main())
