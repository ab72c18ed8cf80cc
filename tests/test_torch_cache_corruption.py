"""A corrupt `CharacterizationCache` of the port is a miss -- the cases
of tests/test_cache_corruption.py against `repro_torch.core.transforms`.

A truncated or schema-corrupt cache file (torn write, bad sector,
version skew from a crashed writer) must never raise out of the load
paths: byte truncation anywhere is at worst a whole-circuit miss, a
schema-corrupt *entry* inside valid JSON is an entry-level miss, and
re-characterization atomically rewrites the file.  The clean run
(``backend="python"`` on the CPU) is held to the reference package's
python backend on the same circuit.
"""

import json
from pathlib import Path

import pytest

from repro.core.circuits import gen_adder as r_gen_adder
from repro.core.transforms import characterize_suite as r_characterize_suite
from repro_torch.core.circuits import gen_adder
from repro_torch.core.transforms import CharacterizationCache, characterize_suite
from repro_torch.runtime import faults

CPU = "cpu"
RECIPES = [(), ("Rw",), ("Ba", "Rw")]


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disable()
    yield
    faults.disable()


def characterize(adder, cache):
    return characterize_suite({"adder": adder}, RECIPES, cache=cache, n_jobs=1,
                              backend="python", device=CPU)


def assert_reference_stats(cha):
    """``{"adder": {recipe: AigStats}}`` equal to the reference's python
    backend on the same adder."""
    ref = r_characterize_suite({"adder": r_gen_adder(6)}, RECIPES, n_jobs=1, backend="python")
    assert list(cha["adder"]) == list(ref["adder"])
    assert {r: s.to_dict() for r, s in cha["adder"].items()} == {
        r: s.to_dict() for r, s in ref["adder"].items()
    }


@pytest.fixture()
def warm_cache(tmp_path):
    adder = gen_adder(6)
    cache = CharacterizationCache(tmp_path)
    clean = characterize(adder, cache)
    assert_reference_stats(clean)
    return adder, cache, clean


def _cache_files(cache) -> list[Path]:
    files = sorted(Path(cache.root).rglob("*.json"))
    assert files, "warm run persisted nothing"
    return files


def test_byte_truncation_is_a_miss_never_a_crash(warm_cache):
    adder, cache, _ = warm_cache
    fp = adder.fingerprint()
    for path in _cache_files(cache):
        data = path.read_bytes()
        for cut in (0, 1, len(data) // 2, len(data) - 1):
            path.write_bytes(data[:cut])
            # None of the loaders may raise on any truncation point.
            cache.load(fp)
            cache.load_applications(fp)
            cache.load_aig(path.stem)
        path.write_bytes(data)
    # A truncated persisted AIG specifically must read back as a miss.
    aigs = sorted(Path(cache.root).rglob("aigs/*.json"))
    assert aigs
    aig_path = aigs[0]
    data = aig_path.read_bytes()
    aig_path.write_bytes(data[: len(data) // 2])
    assert cache.load_aig(aig_path.stem) is None


def test_truncated_cache_recovers_by_recharacterizing(warm_cache):
    adder, cache, clean = warm_cache
    for path in _cache_files(cache):
        data = path.read_bytes()
        path.write_bytes(data[: max(1, len(data) // 3)])
    assert cache.load(adder.fingerprint()) == {}
    assert characterize(adder, cache) == clean
    # The rewrite healed the cache: a fresh instance warm-hits.
    healed = CharacterizationCache(cache.root)
    assert characterize(adder, healed) == clean
    assert healed.hits == 1 and healed.misses == 0


def test_schema_corrupt_entry_is_entry_level_miss(warm_cache):
    adder, cache, _ = warm_cache
    fp = adder.fingerprint()
    path = cache._path(fp)
    raw = json.loads(path.read_text())
    keys = list(raw["recipes"])
    assert len(keys) >= 3
    raw["recipes"][keys[0]] = {"wrong": "shape"}  # bad stats dict
    raw["recipes"][keys[1]] = 17  # not a dict at all
    path.write_text(json.dumps(raw))
    loaded = cache.load(fp)
    # The good entries survive; only the corrupt two are misses.
    assert {",".join(r) for r in loaded} == set(keys[2:])


def test_wrong_toplevel_json_type_is_a_miss(warm_cache):
    adder, cache, _ = warm_cache
    fp = adder.fingerprint()
    for payload in ("[1, 2, 3]", '"a string"', "17", "null"):
        cache._path(fp).write_text(payload)
        assert cache.load(fp) == {}
        cache._apps_path(fp).write_text(payload)
        assert cache.load_applications(fp) == {}


def test_injected_store_corruption_roundtrip(tmp_path):
    """End to end through the cache.store fault point: every persisted
    file is torn mid-write, warm loads all miss, and the next run
    recovers by re-characterizing and rewriting atomically."""
    adder = gen_adder(6)
    cache = CharacterizationCache(tmp_path)
    with faults.injected(faults.FaultRule("cache.store", "corrupt", count=None)):
        clean = characterize(adder, cache)
    assert_reference_stats(clean)
    assert cache.load(adder.fingerprint()) == {}
    assert characterize(adder, cache) == clean
