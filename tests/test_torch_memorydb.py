"""The port's MemoryDB (sorted chunks of keys, ROADMAP C.12) against the
reference's (one sorted list): the same puts, overwrites and deletes over
several families leave the same `scan_all` and the same `range_iter`
over any bounds, byte for byte, however the port's chunks split and
empty; and no chunk outgrows its bound."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpubft.storage import MemoryDB as RMemoryDB
from tpubft.storage import WriteBatch as RWriteBatch
from tpubft_torch.storage import MemoryDB, WriteBatch

# the default family, short ones, one that sorts after the others, and
# the one family whose range has no upper bound (255 bytes of 0xFF)
FAMILIES = [b"", b"a", b"blk", b"\x7fz", b"\xff" * 255]


def _pair(chunk_max=None):
    port = MemoryDB()
    if chunk_max is not None:
        port.CHUNK_MAX = chunk_max
    return port, RMemoryDB()


def _apply(port, ref, ops) -> None:
    """ops: (family, key, value-or-None) in one batch a call."""
    pb, rb = WriteBatch(), RWriteBatch()
    for fam, key, value in ops:
        if value is None:
            pb.delete(key, family=fam)
            rb.delete(key, family=fam)
        else:
            pb.put(key, value, family=fam)
            rb.put(key, value, family=fam)
    port.write(pb)
    ref.write(rb)


def _check_chunks(db) -> None:
    """The chunks' invariants: none empty or past its bound, each first
    key recorded, and together the map's keys in order."""
    assert len(db._chunks) == len(db._firsts)
    for chunk, first in zip(db._chunks, db._firsts):
        assert 0 < len(chunk) <= db.CHUNK_MAX
        assert chunk[0] == first
    flat = [k for chunk in db._chunks for k in chunk]
    assert flat == sorted(db._map)


def _same_scans(port, ref, bounds) -> None:
    assert list(port.scan_all()) == list(ref.scan_all())
    for fam in FAMILIES:
        assert list(port.range_iter(fam)) == list(ref.range_iter(fam))
        for start, end in bounds:
            assert (list(port.range_iter(fam, start=start, end=end))
                    == list(ref.range_iter(fam, start=start, end=end)))
    _check_chunks(port)


_keys = st.binary(min_size=0, max_size=3)
_op = st.tuples(st.sampled_from(FAMILIES), _keys,
                st.one_of(st.none(), st.binary(max_size=4)))


@settings(max_examples=60, deadline=None)
@given(batches=st.lists(st.lists(_op, min_size=1, max_size=40),
                        min_size=1, max_size=12),
       bounds=st.lists(st.tuples(st.one_of(st.none(), _keys),
                                 st.one_of(st.none(), _keys)),
                       max_size=6),
       chunk_max=st.sampled_from([1, 2, 3, 8]))
def test_random_ops_scan_like_the_reference(batches, bounds, chunk_max):
    """Random puts, overwrites and deletes (deletes of absent keys too),
    with chunks of 1-8 keys so that they split and empty often."""
    port, ref = _pair(chunk_max)
    for ops in batches:
        _apply(port, ref, ops)
    _same_scans(port, ref, bounds)


@pytest.mark.parametrize("chunk_max", [1, 5, 64, None])
def test_seeded_load_and_prune_scan_like_the_reference(chunk_max):
    """A seeded load of 3,000 rows over every family in batches, then a
    prune of a third of them (as `prune_versions` deletes archive rows)
    and overwrites: equal scans over 40 random bounds at each stage,
    with the default chunk bound too."""
    rng = np.random.default_rng(22)
    port, ref = _pair(chunk_max)
    keys = [(FAMILIES[int(rng.integers(len(FAMILIES)))],
             rng.bytes(int(rng.integers(1, 6))))
            for _ in range(3000)]

    def bounds():
        out = []
        for _ in range(40):
            a, b = rng.bytes(2), rng.bytes(2)
            out.append((min(a, b), max(a, b)) if rng.random() < 0.8
                       else (a, None))
        return out
    for i in range(0, len(keys), 250):
        _apply(port, ref, [(f, k, b"v%d" % j) for j, (f, k)
                           in enumerate(keys[i:i + 250], i)])
    _same_scans(port, ref, bounds())
    doomed = rng.choice(len(keys), size=len(keys) // 3, replace=False)
    _apply(port, ref, [(*keys[j], None) for j in doomed])
    _same_scans(port, ref, bounds())
    _apply(port, ref, [(*keys[j], b"w%d" % j) for j in range(0, 3000, 7)])
    _same_scans(port, ref, bounds())


def test_twenty_thousand_inserts_keep_every_chunk_bounded():
    """20,000 inserts in an order that is not sorted: every chunk at or
    below CHUNK_MAX (and at least half full, as halves of a split), the
    rows in order."""
    db = MemoryDB()
    rng = np.random.default_rng(7)
    for block in range(20):
        b = WriteBatch()
        for _ in range(1000):
            b.put(rng.bytes(8), b"x", family=b"kv")
        db.write(b)
    assert len(db._map) == 20000
    _check_chunks(db)
    assert len(db._chunks) > 20000 // db.CHUNK_MAX
    assert all(len(c) >= db.CHUNK_MAX // 2 for c in db._chunks)


def test_deleting_every_row_leaves_no_chunk():
    """Chunks that empty are dropped, and the emptied DB scans nothing
    and takes rows again."""
    port, ref = _pair(4)
    rows = [(b"a", b"%03d" % i, b"v") for i in range(50)]
    _apply(port, ref, rows)
    _apply(port, ref, [(f, k, None) for f, k, _v in rows[::-1]])
    assert port._chunks == [] and port._firsts == []
    _same_scans(port, ref, [(None, None), (b"0", b"9")])
    _apply(port, ref, rows[:3])
    _same_scans(port, ref, [(b"001", None)])
