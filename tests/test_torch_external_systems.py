"""The port's external-system adapters
(``summerset_tpu_torch/client/external_systems.py``) against the JAX
package's: the pure command mapping (key to znode path, value encoding)
and the gating errors when the client libraries (``kazoo``, ``etcd3``)
are absent, as neither this machine nor the card's holds them."""

import pytest

from summerset_tpu.client import external_systems as jext
from summerset_tpu_torch.client import external_systems as text
from summerset_tpu_torch.utils.errors import SummersetError

PATHS = [("/summerset", "a/b"), ("/summerset/", "k"), ("/p", ""),
         ("/", "x/y/z"), ("/summerset", "héllo")]


@pytest.mark.parametrize("prefix,key", PATHS)
def test_zk_path_equals_jax(prefix, key):
    assert text.zk_path(prefix, key) == jext.zk_path(prefix, key)


def test_zk_path_mapping():
    assert text.zk_path("/summerset", "a/b") == "/summerset/a_b"
    assert text.zk_path("/summerset/", "k") == "/summerset/k"


@pytest.mark.parametrize("value", ["héllo", "", "v" * 3000, "a\x00b"])
def test_value_roundtrip_equals_jax(value):
    raw = text.encode_value(value)
    assert raw == jext.encode_value(value)
    assert text.decode_value(raw) == jext.decode_value(raw) == value


def test_decode_value_none_and_bad_bytes_equal_jax():
    assert text.decode_value(None) is None
    bad = b"\xff\xfeok"
    assert text.decode_value(bad) == jext.decode_value(bad)


def _gate_message(mod, make):
    with pytest.raises(Exception) as exc:
        make(mod)
    return type(exc.value).__name__, str(exc.value)


@pytest.mark.parametrize("make", [
    lambda m: m.ZooKeeperSession("127.0.0.1:2181", timeout=0.1),
    lambda m: m.EtcdKvClient(("127.0.0.1", 2379), timeout=0.1),
], ids=["zookeeper", "etcd"])
def test_adapters_gated_without_their_library(make):
    """Without ``kazoo``/``etcd3`` each adapter raises the package's
    ``SummersetError`` naming the missing library, as the JAX one does."""
    got = _gate_message(text, make)
    assert got == _gate_message(jext, make)
    with pytest.raises(SummersetError):
        make(text)
