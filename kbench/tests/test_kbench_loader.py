"""A configuration names its generator and its reference, and the harness
loads them by path: the default, a path that is not there, and the two
cells' Syncs and reference replies as they were before the loader."""

import hashlib
import json

import numpy as np
import pytest

from kbench import manifest

CELLS = ("basic5k.bind", "basic5k.bind_wave")
# sha256 over every Sync of 16 steps (the cold one first) for seeds 1, 2, 3,
# as the generator imported by name made them before the loader
SYNC_DIGESTS = {
    1: "6d386d543af819e2968d02cf7617aac41ce95a4b4def69021fee737e6acfb216",
    2: "e42935fb1c4e6ecf5dc72dfba34a707f5b87cc321b667cd01c3a6abbdbb0e121",
    3: "c5c4054c23cb9b141125cccbe11cb6fd781a8fd6e6f5739b022743d80fcd154f",
}
# sha256 over the reference's Score and Assign replies of 4 steps of the
# cell cut to 24 nodes and 96 pods, for seeds 1, 2, 3, as before the loader
# (the reference has no wave: both cells read alike)
REPLY_DIGESTS = {
    1: "8b64d56c36871618006df0475fa60d0498ad91cc73fd26d19750ba52da65135d",
    2: "0addee93e54b8a4a1cb12c22670e12dbe6428c9936af87e0cbe71a5a0d31c30e",
    3: "bd43d6f08e07d6145d82ea26f8b6f6a62bd4d6c9fe85b8f98e0b8002b09939aa",
}


def digest(sequence) -> str:
    """One sha256 over a sequence of dicts (or tuples) of arrays, in order."""
    h = hashlib.sha256()
    for item in sequence:
        pairs = sorted(item.items()) if isinstance(item, dict) else enumerate(item)
        for key, value in pairs:
            a = np.asarray(value).astype(np.int64)
            h.update(str(key).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        h.update(b"|")
    return h.hexdigest()


def spread_assign(model, step):
    """A reply that places four pods in five, spread over the nodes."""
    P, N = model.preq.shape[0], model.nalloc.shape[0]
    i = np.arange(P)
    placed = (i + step) % 5 != 0
    return np.where(placed, (i * 7 + step) % N, -1), np.where(placed, 0, 1)


def test_no_generator_key_loads_the_cluster_generator():
    import kbench.gen.cluster

    cell = manifest.load_cell("basic5k.bind")
    assert "generator" not in cell.config
    assert cell.generator is kbench.gen.cluster
    assert cell.reference.__file__ == str(manifest.ROOT / cell.config["reference"])


@pytest.mark.parametrize("key", ["generator", "reference"])
def test_a_module_that_is_not_there_fails_at_load_by_its_path(tmp_path, key):
    import shutil

    shutil.copytree(manifest.ROOT / "kbench", tmp_path / "kbench")
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    doc = manifest.load_manifest(tmp_path)
    cell = doc["workloads"][0]["name"]
    assert manifest.load_cell(cell, root=tmp_path).generator.__file__.startswith(str(tmp_path))
    conf = tmp_path / doc["configs"][0]["file"]
    conf.write_text(json.dumps(dict(json.loads(conf.read_text()), **{key: "kbench/gen/gone.py"})))
    with pytest.raises(FileNotFoundError, match="kbench/gen/gone.py"):
        manifest.load_cell(cell, root=tmp_path)


def test_a_module_outside_the_package_loads_from_its_file(tmp_path):
    source = (manifest.ROOT / "kbench" / "reference" / "cycle.py").read_text()
    (tmp_path / "own_reference.py").write_text(source)
    module = manifest.load_module(str(tmp_path / "own_reference.py"))
    assert module.__file__ == str(tmp_path / "own_reference.py")
    assert manifest.load_module(str(tmp_path / "own_reference.py")) is module
    import kbench.reference.cycle

    assert module is not kbench.reference.cycle and callable(module.assign_reply)


@pytest.mark.parametrize("seed", sorted(SYNC_DIGESTS))
@pytest.mark.parametrize("name", CELLS)
def test_the_cells_syncs_are_as_before(name, seed):
    cell = manifest.load_cell(name)
    gen = cell.generator
    model = gen.build(cell.config, seed)
    loop = gen.BindLoop(model, cell.traffic["lifetime_steps"], seed)
    syncs = [gen.full_sync_kwargs(model)]
    for step in range(16):
        after = loop.after_assign(model, *spread_assign(model, step))
        syncs.append(gen.sync_kwargs(model, after))
        model = after
    assert digest(syncs) == SYNC_DIGESTS[seed]


@pytest.mark.parametrize("seed", sorted(REPLY_DIGESTS))
@pytest.mark.parametrize("name", CELLS)
def test_the_cells_reference_replies_are_as_before(tiny_cell, name, seed):
    cell = tiny_cell(name, nodes=24, pending=96, init=8)
    gen, ref = cell.generator, cell.reference
    cycle, k = cell.traffic["cycle"], int(cell.traffic["top_k"])
    model = gen.build(cell.config, seed)
    loop = gen.BindLoop(model, cell.traffic["lifetime_steps"], seed)
    replies = []
    for _ in range(4):
        assign = ref.assign_reply(model, cycle)
        replies += [ref.score_reply(model, cycle, k), assign]
        model = loop.after_assign(model, *assign)
    assert digest(replies) == REPLY_DIGESTS[seed]
