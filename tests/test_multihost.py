"""Multi-host execution: a REAL 2-process jax.distributed run through
the production engine. Exercises local_region_pairs (round-robin region
split across processes) and allreduce_region_maps (pickled allgather merge)
— the code path that mirrors the reference's Pool-over-regions + driver
reduce (reference coolpup.py:1502–1531) across hosts."""

import os
import socket
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_toy_cooler, toy_features, toy_regions  # noqa: E402

from coolpuppy_tpu import pileup  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pileup_equals_single(tmp_path):
    cool_path = str(tmp_path / "mh.cool")
    clr, dense, weights = make_toy_cooler(cool_path, seed=7)
    out_path = str(tmp_path / "mh_result.npz")
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE)] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.join(HERE, "multihost_worker.py"),
                str(i),
                str(port),
                cool_path,
                out_path,
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=570)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    assert os.path.exists(out_path)

    got = np.load(out_path, allow_pickle=True)

    want = pileup(
        clr,
        toy_features(),
        features_format="bed",
        view_df=toy_regions(),
        flank=3_000_000,
        mindist=0,
        nshifts=1,
        seed=0,
        by_strand=True,
    ).set_index("orientation")

    assert list(got["orientations"]) == list(want.index)
    for i, ori in enumerate(want.index):
        assert int(got["n"][i]) == int(want.loc[ori, "n"])
        np.testing.assert_allclose(
            got["data"][i],
            want.loc[ori, "data"],
            rtol=1e-5,
            atol=1e-8,
            err_msg=f"orientation {ori}",
        )
