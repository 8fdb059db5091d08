"""The port's object stores (tpubft_torch/storage/objectstore.py, s3.py)
and S3 test server (tpubft_torch/testing/s3server.py) against the
reference's: the tests of tests/test_s3.py that need no read-only
replica, each run with the port's client on the port's server, the
port's client on the reference's server and the reference's client on
the port's server (real HTTP, real SigV4); SigV4 headers equal for a
fixed clock; sealed objects equal byte for byte on disk
(FsObjectStore); and the read-only replica's archival writes
(test_ro_replica_archives_to_s3) with the port's archive keys, which are
the reference's. The read-only replica process archiving over S3 is in
tests/test_torch_readonly.py."""
import datetime
import os

import numpy as np
import pytest

from tpubft.storage import objectstore as ref_objectstore
from tpubft.storage import s3 as ref_s3
from tpubft.testing.s3server import S3TestServer as RefS3TestServer
from tpubft_torch import testing
from tpubft_torch.storage import objectstore, s3
from tpubft_torch.storage.s3 import S3Error, S3ObjectStore
from tpubft_torch.testing.s3server import S3TestServer

PAIRS = {"port-port": (S3ObjectStore, S3Error, S3TestServer),
         "port-on-ref-server": (S3ObjectStore, S3Error, RefS3TestServer),
         "ref-on-port-server": (ref_s3.S3ObjectStore, ref_s3.S3Error,
                                S3TestServer)}


@pytest.fixture(params=sorted(PAIRS))
def pair(request):
    store_cls, error_cls, server_cls = PAIRS[request.param]
    with server_cls(access_key="test-ak", secret_key="test-sk",
                    max_keys=3) as srv:
        yield store_cls, error_cls, srv


def _store(pair, **kw):
    store_cls, _, srv = pair
    return store_cls(srv.endpoint, "bkt", access_key="test-ak",
                     secret_key="test-sk", **kw)


def test_put_get_exists_delete_roundtrip(pair):
    st = _store(pair)
    assert st.get("a/b") is None
    assert not st.exists("a/b")
    st.put("a/b", b"block-payload")
    assert st.exists("a/b")
    assert st.get("a/b") == b"block-payload"
    st.delete("a/b")
    assert st.get("a/b") is None
    st.delete("a/b")                      # idempotent


def test_sigv4_rejected_on_wrong_secret(pair):
    store_cls, error_cls, srv = pair
    bad = store_cls(srv.endpoint, "bkt", access_key="test-ak",
                    secret_key="WRONG")
    with pytest.raises(error_cls, match="403"):
        bad.put("k", b"v")
    with pytest.raises(error_cls, match="403"):
        bad.get("k")


def test_unsigned_client_rejected_when_server_requires_auth(pair):
    store_cls, error_cls, srv = pair
    anon = store_cls(srv.endpoint, "bkt")
    with pytest.raises(error_cls, match="403"):
        anon.put("k", b"v")


def test_integrity_seal_survives_the_wire(pair):
    st = _store(pair)
    st.put("blocks/1", b"payload-1")
    pair[2].corrupt("bkt/blocks/1")
    assert st.get("blocks/1") is None     # corrupt read -> None, not junk


def test_list_paginates_with_continuation_tokens(pair):
    st = _store(pair)
    for i in range(10):
        st.put(f"blk/{i:04d}", b"x")
    st.put("other/zzz", b"y")
    # server pages at max_keys=3: full listing requires 4 continuations
    assert list(st.list("blk/")) == [f"blk/{i:04d}" for i in range(10)]
    assert list(st.list()) == [f"blk/{i:04d}" for i in range(10)] \
        + ["other/zzz"]


def test_keys_needing_url_encoding_sign_correctly(pair):
    """Keys with spaces/'+'/unicode must survive SigV4 canonicalization
    (the signature is over the raw path, quoted exactly once)."""
    st = _store(pair)
    for key in ("a key/with spaces", "plus+plus", "uni/éé"):
        st.put(key, key.encode())
        assert st.exists(key)
        assert st.get(key) == key.encode()
    assert "a key/with spaces" in list(st.list("a key/"))


def test_key_prefix_namespacing(pair):
    a = _store(pair, prefix="replica-4/")
    b = _store(pair, prefix="replica-5/")
    a.put("blocks/1", b"from-a")
    b.put("blocks/1", b"from-b")
    assert a.get("blocks/1") == b"from-a"
    assert b.get("blocks/1") == b"from-b"
    assert list(a.list()) == ["blocks/1"]


def test_server_error_surfaces_as_s3error(pair):
    st = _store(pair)
    pair[2].fail_next = 1
    with pytest.raises(pair[1], match="500"):
        st.put("k", b"v")
    st.put("k", b"v")                     # next request succeeds
    assert st.get("k") == b"v"


def test_ro_replica_archives_to_s3(pair):
    """The RO replica's archival writes ride the S3 backend unchanged
    (the same IObjectStore seam as the filesystem store), under the
    reference's archive keys."""
    from tpubft.kvbc.readonly import archive_key as ref_archive_key
    from tpubft.kvbc.readonly import digest_key as ref_digest_key
    from tpubft_torch.kvbc.readonly import archive_key, digest_key
    st = _store(pair, prefix="ro-4/")
    for blk in (1, 2, 3, 10 ** 12):
        assert archive_key(blk) == ref_archive_key(blk)
        assert digest_key(blk) == ref_digest_key(blk)
    for blk in (1, 2, 3):
        st.put(archive_key(blk), b"raw-block-%d" % blk)
    assert [archive_key(b) for b in (1, 2, 3)] == list(st.list())
    assert st.get(archive_key(2)) == b"raw-block-2"


def test_sigv4_headers_equal_the_reference_for_a_fixed_clock():
    now = datetime.datetime(2026, 1, 2, 3, 4, 5,
                            tzinfo=datetime.timezone.utc)
    rng = np.random.default_rng(4)
    for path, query in (("/bkt/a key/uni/éé", ""),
                        ("/bkt", "list-type=2&prefix=blk%2F&max-keys=3")):
        payload = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
        for method in ("PUT", "GET"):
            args = (method, "127.0.0.1:9000", path, query, payload,
                    "ak", "sk")
            assert s3.sigv4_headers(*args, now=now) == \
                ref_s3.sigv4_headers(*args, now=now)


def test_s3_test_server_is_exported_from_testing():
    assert testing.S3TestServer is S3TestServer


def test_fs_object_store_seals_equal_the_reference(tmp_path):
    """Seeded objects through the port's FsObjectStore and the
    reference's: the same files, byte for byte (sha256 seal + data);
    each store reads the other's objects and lists the same keys."""
    rng = np.random.default_rng(6)
    objs = {f"ro-4/blocks/{i:04d}": rng.integers(
        0, 256, int(rng.integers(0, 500)), dtype=np.uint8).tobytes()
        for i in range(12)}
    port = objectstore.FsObjectStore(str(tmp_path / "port"))
    ref = ref_objectstore.FsObjectStore(str(tmp_path / "ref"))
    for k, v in objs.items():
        port.put(k, v)
        ref.put(k, v)
    for k in objs:
        with open(tmp_path / "port" / k, "rb") as f:
            a = f.read()
        with open(tmp_path / "ref" / k, "rb") as f:
            b = f.read()
        assert a == b == objectstore._seal(objs[k])
    other = objectstore.FsObjectStore(str(tmp_path / "ref"))
    assert list(other.list()) == list(ref.list()) == sorted(objs)
    assert {k: other.get(k) for k in objs} == objs
    # a torn object reads as None in both
    k = sorted(objs)[3]
    with open(tmp_path / "ref" / k, "r+b") as f:
        f.truncate(40)
    assert other.get(k) is None and ref.get(k) is None
    with pytest.raises(ValueError, match="escapes"):
        port.put("../outside", b"x")
    assert not os.path.exists(tmp_path / "outside")


def test_in_memory_store_and_seal_match_the_reference():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    assert objectstore._seal(data) == ref_objectstore._seal(data)
    assert objectstore._unseal(objectstore._seal(data)) == data
    assert objectstore._unseal(b"short") is None
    assert objectstore._unseal(None) is None
    st = objectstore.InMemoryObjectStore()
    st.put("a/1", data)
    st.put("b/1", b"x")
    assert st.get("a/1") == data and st.exists("a/1")
    assert list(st.list("a/")) == ["a/1"]
    st.corrupt("a/1")
    assert st.get("a/1") is None
    st.delete("a/1")
    assert not st.exists("a/1")
