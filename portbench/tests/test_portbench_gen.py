"""The frozen generator gives every seed the same work."""

import json

import numpy as np
import pytest

from portbench import gen, run


def _cells():
    bench = run.manifest()
    return [run.resolve(bench, w["name"]) for w in bench["workloads"]]


@pytest.mark.parametrize("cell", _cells(), ids=lambda c: c["cell"]["name"])
def test_every_seed_does_the_stated_work(cell):
    conf, tr = cell["config"], cell["traffic"]
    shape = conf["shape"]
    S, stride = tr.get("snapshots", 0), tr.get("snapshot_stride", 16)
    stated = {**conf["counts"], **tr["counts"]}
    assert {k: v for k, v in gen.counts(shape, S, stride).items()
            if k in stated} == stated
    seen = set()
    for seed in range(12):
        cols = gen.columns(seed, shape["replicas"], shape["members"],
                           shape["ops_per_actor"], shape["rm_every"],
                           shape["rm_back"])
        measured = gen.measured_counts(cols, shape["replicas"],
                                       shape["ops_per_file"], S, stride)
        assert {k: measured[k] for k in stated} == stated
        seen.add(hash(cols[1][:64].tobytes()))
    assert len(seen) > 1, "the seed must pick the members"


def test_files_cut_each_actor_alike():
    cols = gen.columns(2**31 + 9, 16, 32, 100, 10, 5)
    files = gen.files(cols, gen.actor_ids(2**31 + 9, 16), 100, 48)
    assert [len(ops) for _, _, _, ops in files[:3]] == [48, 48, 4]
    assert [v for _, _, v, _ in files[:4]] == [1, 2, 3, 1]


def test_removes_aim_at_an_earlier_add_of_the_same_actor():
    kind, member, actor, counter = gen.columns(7, 8, 64, 96, 10, 5)
    for a in range(8):
        k, m, c = (x[actor == a] for x in (kind, member, counter))
        for p in np.flatnonzero(k == 1):
            assert k[p - 5] == 0 and m[p - 5] == m[p]
            assert c[p] == (k[:p] == 0).sum()


def test_ids_and_keys_follow_the_seed():
    assert gen.actor_ids(3, 10) == gen.actor_ids(3, 10)
    assert gen.actor_ids(3, 10) != gen.actor_ids(4, 10)
    json.dumps(gen.counts({"replicas": 4, "members": 8, "ops_per_actor": 24,
                           "rm_every": 10, "rm_back": 5, "ops_per_file": 6}))
