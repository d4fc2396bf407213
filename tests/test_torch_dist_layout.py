"""Endpoint layouts and the bootstrap handshake of the port
(minio_tpu_torch/dist/endpoint.py, dist/peer.py) against the JAX
package's: ellipses expansion, locality, set sizes, pool layouts and the
layout signature on the JAX tests' inputs (tests/test_cluster.py:25-110),
string for string; a port node and a JAX node started with the same
endpoints pass each other's bootstrap, and a node started with other
endpoints is refused by both. Tolerance: exact strings."""

import pytest

from tests import torch_dist as td
from tests.torch_dist import fast_clients  # noqa: F401 - the fixture

ARGS = [
    "/data/disk{1...4}", "plain", "http://h{1...2}/d{1...2}", "/d{01...03}",
    "http://h{1...2}:9000/d{1...4}", "http://host{1...4}/export{1...4}",
    "http://10.0.0.{1...3}:9000/mnt/d{001...004}",
]


@pytest.mark.parametrize("arg", ARGS)
def test_expand_ellipses_equal(arg):
    assert td.torch_endpoint.expand_ellipses(arg) == td.jax_endpoint.expand_ellipses(arg)


def test_bad_ranges_refused_by_both():
    for m in (td.jax_endpoint, td.torch_endpoint):
        with pytest.raises(ValueError):
            m.expand_ellipses("/d{4...1}")
        for bad in ("ftp://h/disk", "http://h:9000"):
            with pytest.raises(ValueError):
                m.parse_endpoint(bad)


@pytest.mark.parametrize("case", [
    ("/data/disk1", {}),
    ("http://10.0.0.5:9000/disk1", {"local_names": {"127.0.0.1"}}),
    ("http://127.0.0.1:9000/disk1", {"local_port": 9000, "local_names": {"127.0.0.1"}}),
    ("http://127.0.0.1:9002/disk1", {"local_port": 9000, "local_names": {"127.0.0.1"}}),
    ("http://h3/x/", {"local_names": set()}),
])
def test_parse_endpoint_equal(case):
    arg, kw = case
    j = td.jax_endpoint.parse_endpoint(arg, **kw)
    t = td.torch_endpoint.parse_endpoint(arg, **kw)
    assert (t.host, t.port, t.path, t.is_local, t.url, t.node) == \
        (j.host, j.port, j.path, j.is_local, j.url, j.node)


@pytest.mark.parametrize("n,nodes,pinned", [
    (16, 1, 0), (32, 1, 0), (4, 1, 0), (1, 1, 0), (24, 3, 0), (16, 1, 8),
    (16, 4, 0), (12, 2, 0), (20, 4, 0), (18, 3, 0), (7, 1, 0)])
def test_choose_set_drive_count_equal(n, nodes, pinned):
    assert td.torch_endpoint.choose_set_drive_count(n, nodes, pinned) == \
        td.jax_endpoint.choose_set_drive_count(n, nodes, pinned)


@pytest.mark.parametrize("groups,sdc", [
    ([["http://h{1...2}:9000/d{1...4}"]], 0),
    ([["http://h{1...2}:9000/d{1...2}"]], 0),
    ([["http://host{1...4}/export{1...4}"]], 0),
    ([["http://127.0.0.1:19001/n1/disk{1...4}", "http://127.0.0.1:19002/n2/disk{1...4}"]], 0),
    ([["http://a:1/d{1...8}"], ["http://b:2/d{1...4}", "http://c:3/d{1...4}"]], 4),
    ([["/data/disk{1...16}"]], 0),
])
def test_pool_layouts_and_signature_equal(groups, sdc):
    kw = dict(local_host="127.0.0.1", local_port=19001, set_drive_count=sdc,
              local_names={"127.0.0.1"})
    j = td.jax_endpoint.create_pool_layouts(groups, **kw)
    t = td.torch_endpoint.create_pool_layouts(groups, **kw)
    assert [(p.set_drive_count, p.set_count,
             [(e.url, e.is_local) for e in p.endpoints]) for p in t] == \
        [(p.set_drive_count, p.set_count,
          [(e.url, e.is_local) for e in p.endpoints]) for p in j]
    assert td.torch_endpoint.layout_signature(t) == td.jax_endpoint.layout_signature(j)


def _node(pkg, args, port, rpc_map, tmp_path, tag):
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return td.PKG[pkg].cluster.ClusterNode(
        args, host="127.0.0.1", port=port, secret=td.SECRET,
        root_dir_map=lambda p: str(tmp_path / (tag + p.replace("/", "_"))),
        local_names=td.LOCAL, rpc_port=rpc_map[port],
        rpc_port_of=lambda h, p: rpc_map[p], parity=2, **kw)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_mixed_bootstrap_passes_and_mismatch_is_refused(tmp_path, fast_clients, first):
    """A JAX node and a port node with the same endpoint arguments agree
    on the signature and pass each other's handshake; a third node of
    either package started with other arguments is refused with
    CorruptedFormat by both."""
    second = "torch" if first == "jax" else "jax"
    p1, p2, p3 = 19101, 19102, 19103
    rpc_map = {p: td.free_port() for p in (p1, p2, p3)}
    args = [[f"http://127.0.0.1:{p1}/n1/disk{{1...4}}",
             f"http://127.0.0.1:{p2}/n2/disk{{1...4}}"]]
    a = _node(first, args, p1, rpc_map, tmp_path, "a")
    b = _node(second, args, p2, rpc_map, tmp_path, "b")
    try:
        assert a.layout_sig == b.layout_sig
        a.wait_for_peers(timeout=5)
        b.wait_for_peers(timeout=5)
        for pkg in ("jax", "torch"):
            bad_args = [[f"http://127.0.0.1:{p1}/n1/disk{{1...2}}",
                         f"http://127.0.0.1:{p3}/n3/disk{{1...2}}"]]
            bad = _node(pkg, bad_args, p3, rpc_map, tmp_path, "bad" + pkg)
            try:
                with pytest.raises(Exception) as ei:
                    bad.wait_for_peers(timeout=5)
                assert type(ei.value).__name__ == "CorruptedFormat"
            finally:
                bad.close()
    finally:
        a.close()
        b.close()
