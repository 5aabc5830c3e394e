"""schedulerdump — dump .sdl timeline tracks
(reference ``src/bin/schedulerdump.rs``)."""

import argparse
from pathlib import Path

from ..formats.sdl import SchedulerFile


def main(argv=None):
    ap = argparse.ArgumentParser(prog="schedulerdump", description=__doc__)
    ap.add_argument("sdl", type=Path)
    args = ap.parse_args(argv)

    s = SchedulerFile(args.sdl.read_bytes())
    print(f"{len(s.tracks)} tracks (base {s.base_track}):")
    for i, t in enumerate(s.tracks):
        dti_part = f" dti {t.unit_dti.name}" if t.unit_dti else ""
        print(f"  [{i}] {t.track_type.name} prop_type {t.prop_type} "
              f"name {t.name!r} parent {t.parent}{dti_part}")
        for k in t.keys:
            print(f"      frame {k.frame} mode {k.mode:#x} value {k.value!r}")


if __name__ == "__main__":
    main()
