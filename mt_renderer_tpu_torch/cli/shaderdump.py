"""shaderdump — dump rShader2 objects (reference ``src/bin/shaderdump.rs``)."""

import argparse
from pathlib import Path

from ..formats.mfx import Shader2File


def main(argv=None):
    ap = argparse.ArgumentParser(prog="shaderdump", description=__doc__)
    ap.add_argument("mfx", type=Path)
    args = ap.parse_args(argv)

    s2 = Shader2File(args.mfx.read_bytes())
    for o in s2.objects:
        print(f"{o.obj_type.name:<13} {o.name} (hash {o.name_hash:05x}, "
              f"sindex {o.sindex}, index {o.index})")
        if o.specific is not None:
            print(f"    {o.specific}")


if __name__ == "__main__":
    main()
