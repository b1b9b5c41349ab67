"""Tables of the PyTorch port against the JAX reference: seeded synthesis is
byte-identical, byte accounting is equal, views and the wire format keep
the reference's contracts."""

import numpy as np
import pytest
import torch

import repro.analytics.query as jq
import repro.analytics.table as jt
import repro.runtime.storage as jstorage
import repro_torch.analytics.query as tq
import repro_torch.analytics.table as tt
import repro_torch.runtime.storage as tstorage


def _cols(table) -> dict:
    return {k: tt.to_numpy(v) for k, v in table.columns.items()}


def _dd(d) -> tuple:
    return d.name, dict(d.bytes_per_node), d.rows, d.skew


def _assert_same_bytes(port, reference) -> None:
    a, b = _cols(port), {k: np.asarray(v)
                         for k, v in reference.columns.items()}
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k
    assert port.nbytes == reference.nbytes
    assert port.num_rows == reference.num_rows


@pytest.mark.parametrize("kw", [
    dict(rows=1000, key_space=500, seed=0),
    dict(rows=777, key_space=4096, seed=3, distribution="pareto"),
    dict(rows=256, key_space=256, seed=9, unique_keys=True),
    dict(rows=300, key_space=100, seed=4, value_cols=3),
])
def test_synth_table_byte_identical(kw):
    _assert_same_bytes(tt.synth_table("t", device="cpu", **kw),
                       jt.synth_table("t", **kw))


@pytest.mark.parametrize("kw", [
    dict(rows=2048, dim_rows=256, seed=1),
    dict(rows=4096, dim_rows=512, seed=3, zipf=1.5),
    dict(rows=2048, dim_rows=256, seed=5, heavy_hitters=4),
    dict(rows=1000, dim_rows=300, seed=2, fact_nodes=[0, 2, 5],
         dim_nodes=[1], num_groups=16),
])
def test_synth_query_tables_byte_identical(kw):
    tf, td, tref = tq.synth_query_tables(device="cpu", **kw)
    jf, jd, jref = jq.synth_query_tables(**kw)
    for port, reference in ((tf, jf), (td, jd)):
        assert sorted(port.partitions) == sorted(reference.partitions)
        for node in port.partitions:
            _assert_same_bytes(port.partitions[node],
                               reference.partitions[node])
        assert _dd(port.data_dist()) == _dd(reference.data_dist())
        assert port.nbytes == reference.nbytes
    np.testing.assert_array_equal(tref, jref)
    _assert_same_bytes(tf.gather(), jf.gather())


def test_from_numpy_carries_reference_tables_across():
    jf, jd, _ = jq.synth_query_tables(rows=600, dim_rows=64, seed=8)
    parts = {n: {k: np.asarray(v) for k, v in t.columns.items()}
             for n, t in jf.partitions.items()}
    port = tt.dist_from_numpy("A", parts, device="cpu")
    for n, t in port.partitions.items():
        _assert_same_bytes(t, jf.partitions[n])
    assert _dd(port.data_dist()) == _dd(jf.data_dist())


def test_table_slice_views_and_accounting():
    t = tt.synth_table("t", 100, 50, seed=1, device="cpu")
    jref = jt.synth_table("t", 100, 50, seed=1)
    s, js = t.slice(10, 35), jref.slice(10, 35)
    assert s.nbytes == js.nbytes == 25 * 12 and s.num_rows == 25
    # zero-copy until touched, then the slice drops its parent pin
    assert s.parent_columns["key"].data_ptr() == t["key"].data_ptr()
    _assert_same_bytes(s.materialize(), js.materialize())
    assert s.lo == 0 and s.hi == 25
    keep = t["v0"] > 0
    _assert_same_bytes(t.mask(keep), jref.mask(np.asarray(jref["v0"]) > 0))
    idx = np.array([5, 1, 99, 1])
    _assert_same_bytes(t.take(idx), jref.take(idx))


def test_concat_all_host_and_device_parts():
    t = tt.synth_table("t", 64, 50, seed=2, device="cpu")
    host = tt.Table({k: tt.to_numpy(v) for k, v in t.columns.items()})
    both = tt.Table.concat_all([host.slice(0, 10), host.slice(10, 64)])
    assert all(isinstance(v, np.ndarray) for v in both.columns.values())
    mixed = tt.Table.concat_all([host.slice(0, 10), t.slice(10, 64)])
    assert all(isinstance(v, torch.Tensor) for v in mixed.columns.values())
    _assert_same_bytes(mixed, jt.synth_table("t", 64, 50, seed=2))
    on = tt.on_device(host, "cpu")
    assert all(isinstance(v, torch.Tensor) for v in on.columns.values())
    assert on.nbytes == host.nbytes


def test_phantom_and_split_partitions_match_reference():
    for dist in ("uniform", "pareto"):
        a = tt.phantom("A", 400 << 20, range(5), distribution=dist, seed=3)
        b = jt.phantom("A", 400 << 20, range(5), distribution=dist, seed=3)
        assert _dd(a.data_dist()) == _dd(b.data_dist())
    tf, _, _ = tq.synth_query_tables(rows=1000, dim_rows=64, device="cpu")
    jf, _, _ = jq.synth_query_tables(rows=1000, dim_rows=64)
    ts = tq.split_partitions(tf.partitions, 3)
    js = jq.split_partitions(jf.partitions, 3)
    assert [(n, s.lo, s.hi, s.nbytes) for n, s in ts] == \
        [(n, s.lo, s.hi, s.nbytes) for n, s in js]


def test_wire_format_decodes_into_the_port_table():
    t = tt.synth_table("t", 50, 20, seed=4, device="cpu")
    blob = tstorage.serialize_table(t.slice(5, 30))
    back = tstorage.deserialize_table(blob)
    assert isinstance(back, tt.Table)
    _assert_same_bytes(back, jstorage.deserialize_table(blob))
    # the reference reads the port's bytes and vice versa
    jblob = jstorage.serialize_table(jt.synth_table("t", 50, 20, seed=4))
    _assert_same_bytes(tstorage.deserialize_table(jblob),
                       jt.synth_table("t", 50, 20, seed=4))


def test_entry_points_without_a_device_raise_on_a_cpu_machine(monkeypatch):
    from repro_torch import NoDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        tt.synth_table("t", 10, 10)
    with pytest.raises(NoDeviceError):
        tq.synth_query_tables(rows=64, dim_rows=8)
    with pytest.raises(NoDeviceError):
        tt.from_numpy({"key": np.zeros(3, np.int32)})
