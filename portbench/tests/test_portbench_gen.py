"""The frozen generator gives every seed the same work."""

import json

import numpy as np
import pytest

from harness import cells, driver, small_cell
from portbench import gen, run


@pytest.mark.parametrize("workload", cells())
def test_every_seed_does_the_stated_work(workload):
    cell = run.resolve(run.manifest(), workload)
    conf, tr, work = cell["config"], cell["traffic"], driver(workload)
    stated = {**conf["counts"], **tr["counts"]}
    assert {k: v for k, v in work.stated(conf, tr).items()
            if k in stated} == stated
    for seed in range(12):
        measured = work.measured(conf, tr, seed)
        assert {k: measured[k] for k in stated} == stated


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
    members = {gen.columns(seed, 16, 32, 100, 10, 5)[1].tobytes()
               for seed in range(12)}
    assert len(members) > 1, "the seed must pick the members"
    json.dumps(gen.counts({"replicas": 4, "members": 8, "ops_per_actor": 24,
                           "rm_every": 10, "rm_back": 5, "ops_per_file": 6}))


@pytest.mark.parametrize("workload", cells())
def test_the_small_shape_does_its_stated_work(workload):
    cell = small_cell(workload)
    conf, tr = cell["config"], cell["traffic"]
    stated = {**conf["counts"], **tr["counts"]}
    for seed in (0, 2**31 + 5):
        measured = driver(workload).measured(conf, tr, seed)
        assert {k: measured[k] for k in stated} == stated
