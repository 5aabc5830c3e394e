"""Port: the band split over ``torch.distributed`` processes
(``parallel.multihost``), the counterpart of ``tests/test_multihost.py``.

Two processes form a gloo group through a file rendezvous under the
test's temporary directory (no port can collide) and run
``mt_renderer_tpu_torch.tools.multihost_demo`` on the CPU at 64x64: each
rank holds its rows of the band-split frame (packed, the split peel, the
trilinear frame, the sharded setup) bit for bit to the single-device
frame it renders itself, the geometry split's full frame likewise, and
``gather_full_frame`` gives every rank the whole frame. A second pair of
processes checks that the gathers carry the bits unchanged (a -0.0
survives, where a float sum would make it +0.0). Every process runs
under a timeout. The same band identity is covered in-process by
``tests/test_torch_multichip.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120


def run_ranks(tmp_path, argv_of, n: int = 2) -> list:
    """Start ``n`` processes (``argv_of(rank)``) at once, one intra-op
    thread each; wait for all → their outputs. Fails unless each exits
    0."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = [subprocess.Popen([sys.executable, *argv_of(r)], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def test_two_process_band_split_matches_single_device(tmp_path):
    rdv = (tmp_path / "rdv").as_uri()
    outs = run_ranks(tmp_path, lambda r: [
        "-m", "mt_renderer_tpu_torch.tools.multihost_demo", "--proc", str(r),
        "--nproc", "2", "--coordinator", rdv, "--device", "cpu", "--width",
        "64", "--height", "64", "--peel", "2", "--mipmap", "--setup-shard",
        "--geomsplit", "--gather", "1"])
    for r, out in enumerate(outs):
        assert f"proc {r}: 32 rows from {32 * r} equal" in out, out
        for leg in ("peel2 rows equal", "mipmap rows equal",
                    "setup_shard rows equal", "geometry-split frame equal",
                    "full-frame gather equal"):
            assert f"proc {r}: {leg}" in out, out
        assert out.strip().endswith("MULTIHOST OK"), out


BITS = r"""
import sys
import types

import torch

from mt_renderer_tpu_torch.parallel import multihost, tiles

rank = int(sys.argv[1])
multihost.init(sys.argv[2], 2, rank)
group = multihost.global_row_mesh()
# rank r's band: rows [2r, 2r + 2) of a 3-row frame (the last band is
# cropped to one row); its depth is -0.0 everywhere
rows = torch.full((2 - rank, 4), -0.0)
full = multihost.gather_full_frame(tiles.Band(rows, 2 * rank), 3)
assert full.shape == (3, 4) and (full == 0).all()
assert torch.from_numpy(full).signbit().all(), full
slots = tiles._Slots(types.SimpleNamespace(device=torch.device("cpu")),
                     None, group)
part = torch.zeros(4)
part[rank] = -0.0 if rank == 0 else 2.5
got = slots.gather_sum([part])
assert got.signbit()[0] and got[1] == 2.5, got
assert slots.reduce([torch.tensor([rank], dtype=torch.int32)], "max") == 1
print("BITS OK", flush=True)
"""


def test_gathers_carry_the_bits(tmp_path):
    rdv = (tmp_path / "rdv").as_uri()
    outs = run_ranks(tmp_path, lambda r: ["-c", BITS, str(r), rdv])
    assert all(out.strip().endswith("BITS OK") for out in outs), outs


def test_init_takes_host_port_or_url(monkeypatch):
    """``init`` hands torch a ``tcp://`` URL for a bare host:port and
    passes a URL through."""
    import torch.distributed as dist

    from mt_renderer_tpu_torch.parallel import multihost

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    multihost.init("127.0.0.1:9911", 2, 1)
    multihost.init("file:///x/rdv", 2, 0, backend="nccl")
    assert seen == [
        ("gloo", dict(init_method="tcp://127.0.0.1:9911", world_size=2,
                      rank=1)),
        ("nccl", dict(init_method="file:///x/rdv", world_size=2, rank=0))]
    with pytest.raises(RuntimeError, match="multihost.init"):
        multihost.global_row_mesh()
