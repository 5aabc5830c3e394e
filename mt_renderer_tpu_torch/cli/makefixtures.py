"""makefixtures — generate the synthetic demo/test asset tree.

No real game data ships with the framework; this creates a tiny valid
scene (model, material, shader metadata, textures, character .prp, GMD,
scheduler, packed .arc) usable by every other CLI and the viewers.
"""

import argparse
from pathlib import Path

from .. import fixtures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="makefixtures", description=__doc__)
    ap.add_argument("out_dir", type=Path)
    args = ap.parse_args(argv)

    fixtures.write_fixture_tree(args.out_dir)
    for p in sorted(args.out_dir.rglob("*")):
        if p.is_file():
            print(f"  {p.relative_to(args.out_dir)}  ({p.stat().st_size} bytes)")
    print(f"fixture tree written to {args.out_dir}")


if __name__ == "__main__":
    main()
