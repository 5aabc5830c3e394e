"""mtdeserializer — dump an XFS/.prp object graph
(reference ``src/bin/mtdeserializer.rs``)."""

import argparse
from pathlib import Path

from ..formats import xfs


def _dump(cls, indent=0):
    pad = "  " * indent
    if cls is None:
        print(f"{pad}<null>")
        return
    print(f"{pad}{cls.class_type.name}:")
    for name, values in cls.props:
        if values and isinstance(values[0], xfs.XfsClass):
            print(f"{pad}  {name}:")
            for v in values:
                _dump(v, indent + 2)
        else:
            print(f"{pad}  {name} = {values!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mtdeserializer", description=__doc__)
    ap.add_argument("prp", type=Path)
    args = ap.parse_args(argv)
    _dump(xfs.deserialize(args.prp.read_bytes()))


if __name__ == "__main__":
    main()
