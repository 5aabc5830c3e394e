"""arctool — unpack/pack rArchive files (reference ``src/bin/arctool.rs``)."""

import argparse
from pathlib import Path

from ..formats.arc import repack_archive, unpack_archive


def main(argv=None):
    ap = argparse.ArgumentParser(prog="arctool", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    up = sub.add_parser("unpack", help="extract an archive + info.json manifest")
    up.add_argument("archive", type=Path)
    up.add_argument("-o", "--out", type=Path, default=None,
                    help="output dir (default: archive stem)")

    pk = sub.add_parser("pack", help="rebuild an archive from an unpack dir")
    pk.add_argument("directory", type=Path, help="dir containing info.json")
    pk.add_argument("-o", "--out", type=Path, default=None,
                    help="output .arc (default: <dir>.arc)")

    args = ap.parse_args(argv)
    if args.cmd == "unpack":
        out = args.out or Path(args.archive.stem)
        n = unpack_archive(args.archive, out)
        print(f"unpacked {n} resources to {out}")
    else:
        out = args.out or args.directory.with_suffix(".arc")
        n = repack_archive(args.directory, out)
        print(f"packed {n} resources into {out}")


if __name__ == "__main__":
    main()
