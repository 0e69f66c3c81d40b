"""CSV -> SMILES-per-line corpus converter (replaces the reference's
utils/convert_csv_to_text.py:21-35): reads a MoleculeNet-style CSV, keeps
the rows whose SMILES parse, writes one SMILES per line.

Port of molclr_tpu/cli/convert.py, with the same output.
"""

from __future__ import annotations

import argparse
import csv


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="molclr-convert")
    p.add_argument("input", help="input CSV (a 'smiles' column, or the "
                                 "last column is used)")
    p.add_argument("output", help="output text file, one SMILES per line")
    args = p.parse_args(argv)

    from molclr_tpu_torch.chem.smiles import parse_smiles

    kept = dropped = 0
    with open(args.input, newline="") as fin, open(args.output, "w") as fout:
        reader = csv.reader(fin)
        header = next(reader, None)
        col = None
        if header and "smiles" in [h.lower() for h in header]:
            col = [h.lower() for h in header].index("smiles")
        elif header is not None:
            # no smiles column: the header row is data, its last column
            if parse_smiles(header[-1], strict=False) is not None:
                fout.write(header[-1] + "\n")
                kept += 1
        for row in reader:
            if not row:
                continue
            s = row[col if col is not None else -1]
            if parse_smiles(s, strict=False) is None:
                dropped += 1
                continue
            fout.write(s + "\n")
            kept += 1
    print(f"wrote {kept} SMILES to {args.output} ({dropped} dropped)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
