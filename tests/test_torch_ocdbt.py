"""The port's read-only OCDBT store (``loco_asr_tpu_torch.utils.ocdbt``)
against tensorstore's own ``ocdbt`` kvstore driver, byte for byte: the
keys and values of all five committed orbax steps (the step root's
database and the per-process one it leads into), and databases
tensorstore writes here with interior B-tree nodes, older versions in
version-tree nodes, uncompressed and zstd-compressed nodes, inline and
indirect values.  A corrupt node fails its checksum, and the numbered
manifest kind (which orbax does not write) is refused by name."""

import glob
import os
import shutil

import numpy as np
import pytest

from loco_asr_tpu_torch.utils import ocdbt

ts = pytest.importorskip("tensorstore")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = sorted(glob.glob(os.path.join(ROOT, "exp", "loco", "*", "ckpt", "step_*")))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")


def _tensorstore(root):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(root)}"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _assert_same(root):
    store = ocdbt.OcdbtStore(root)
    want = _tensorstore(root)
    assert store.keys() == sorted(want)
    for key, value in want.items():
        assert store.read(key) == value, key
    return store


@pytest.mark.parametrize("db", ["", "ocdbt.process_0"])
@pytest.mark.parametrize("step", STEPS, ids=lambda s: s.split(os.sep)[-3])
def test_committed_steps_equal_tensorstore(step, db):
    store = _assert_same(os.path.join(step, db))
    assert len(store.keys()) >= 200


CONFIGS = {
    "interior_nodes": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
                       "version_tree_arity_log2": 1},
    "uncompressed": {"compression": None, "max_inline_value_bytes": 100},
    "zstd_level_5": {"compression": {"id": "zstd", "level": 5}},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_written_databases_equal_tensorstore(tmp_path, name):
    root = tmp_path / name
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": CONFIGS[name]}).result()
    rng = np.random.default_rng(7)
    for _ in range(20):                 # 20 commits: generations, version tree
        txn = ts.Transaction()
        for _ in range(15):
            key = f"grp{rng.integers(0, 6)}/item{rng.integers(0, 400):04d}"
            kv.with_transaction(txn).write(key, rng.bytes(int(rng.integers(0, 60)))).result()
        txn.commit_async().result()
    kv.delete_range(ts.KvStore.KeyRange("grp0/item0000", "grp0/item0100")).result()
    store = _assert_same(str(root))
    assert store.generation >= 20


def test_numbered_manifest_is_refused(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv.write("k", b"v").result()
    with pytest.raises(ocdbt.OcdbtError, match="manifest kind 1 is not supported"):
        ocdbt.OcdbtStore(str(tmp_path))


def test_corrupt_node_fails_its_checksum(tmp_path):
    step = os.path.join(tmp_path, "lm")
    shutil.copytree(STEPS[-1], step)
    node = os.path.join(step, "d", os.listdir(os.path.join(step, "d"))[0])
    raw = bytearray(open(node, "rb").read())
    raw[len(raw) // 2] ^= 1
    open(node, "wb").write(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C mismatch"):
        ocdbt.OcdbtStore(step).keys()


def test_missing_data_file_is_named(tmp_path):
    step = os.path.join(tmp_path, "lm")
    shutil.copytree(STEPS[-1], step)
    data = sorted(glob.glob(os.path.join(step, "ocdbt.process_0", "d", "*")),
                  key=os.path.getsize)[-1]
    os.remove(data)
    store = ocdbt.OcdbtStore(step)
    with pytest.raises(ocdbt.MissingFile, match=os.path.basename(data)):
        for key in store.keys():
            store.read(key)
