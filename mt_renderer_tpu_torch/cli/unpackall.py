"""unpackall — unpack every .arc under a game root
(reference ``src/bin/unpackall.rs``; deletion of originals is opt-in here,
where the reference always deletes)."""

import argparse
from pathlib import Path

from ..formats.arc import unpack_archive


def main(argv=None):
    ap = argparse.ArgumentParser(prog="unpackall", description=__doc__)
    ap.add_argument("root", type=Path)
    ap.add_argument("--delete", action="store_true",
                    help="remove each archive after unpacking")
    args = ap.parse_args(argv)

    for path in sorted(args.root.rglob("*.arc")):
        out_dir = path.with_name(path.stem)
        if out_dir.exists():
            raise SystemExit(f"refusing to overwrite {out_dir}")
        print(f"unpacking {path} -> {out_dir} ...")
        out_dir.mkdir(parents=True)
        unpack_archive(path, out_dir)
        if args.delete:
            path.unlink()


if __name__ == "__main__":
    main()
