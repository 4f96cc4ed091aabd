"""The port's matrix ingest against the JAX package's: alist and dense
parsers and writers (byte-identical files), the QC sidecar, the strict token
rule and its messages, the native C++ loader, format sniffing and directory
listing."""

from pathlib import Path

import numpy as np
import pytest

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.codes import _native as jnative
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.codes import _native as tnative
from tests._torch_port_common import code_pair

DATA = Path(__file__).parent.parent / "data"
REFERENCE_ALIST = DATA / "alist_sparse_matrices" / "(N=10240,M=5231,R=0.49,CW=3,GEN=666).alist"
FIELDS = ("chk_adj", "chk_mask", "var_adj", "var_mask", "var_slot", "chk_slot",
          "var_deg", "chk_deg")


def assert_same_graph(a, b):
    assert (a.n_vars, a.n_checks, a.dv_max, a.dc_max, a.n_edges, a.is_regular) == (
        b.n_vars, b.n_checks, b.dv_max, b.dc_max, b.n_edges, b.is_regular)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("which", ["regular", "irregular", "qc", "ragged"])
def test_alist_files_and_sidecars_are_the_jax_packages(tmp_path, which):
    jc, tc = code_pair(which)
    jp, tp = tmp_path / "j.alist", tmp_path / "t.alist"
    jcodes.write_alist(jc, jp)
    tcodes.write_alist(tc, tp)
    assert tp.read_bytes() == jp.read_bytes()
    j_side, t_side = jcodes.alist.qc_sidecar_path(jp), tcodes.alist.qc_sidecar_path(tp)
    assert t_side.exists() == j_side.exists() == (which == "qc")
    if which == "qc":
        assert t_side.read_bytes() == j_side.read_bytes()
    # each package reads the other's file into the same graph and layout
    back = tcodes.read_alist(jp, native=False)
    want = jcodes.read_alist(tp, native=False)
    assert_same_graph(back, want)
    assert back.qc == want.qc == tc.qc
    assert back.fingerprint == tc.fingerprint
    assert tcodes.parse_alist(jp.read_text()).n_edges == jc.n_edges


def test_reference_alist_reads_and_writes_as_in_the_jax_package(tmp_path):
    j = jcodes.read_alist(REFERENCE_ALIST, native=False)
    t = tcodes.read_alist(REFERENCE_ALIST, native=False)
    assert_same_graph(t, j)
    assert t.name == j.name == REFERENCE_ALIST.name
    assert dict(enumerate(np.bincount(t.chk_deg)))[5] == 666
    jcodes.write_alist(j, tmp_path / "j.alist")
    tcodes.write_alist(t, tmp_path / "t.alist")
    assert (tmp_path / "t.alist").read_bytes() == (tmp_path / "j.alist").read_bytes()


@pytest.mark.parametrize("path", sorted((DATA / "dense_matrices").glob("*.txt")),
                         ids=lambda p: p.name)
def test_dense_files_read_and_write_as_in_the_jax_package(tmp_path, path):
    j, t = jcodes.read_dense(path), tcodes.read_dense(path)
    assert_same_graph(t, j)
    jcodes.write_dense(j, tmp_path / "j.txt")
    tcodes.write_dense(t, tmp_path / "t.txt")
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tcodes.parse_dense(path.read_text()).n_edges == j.n_edges


def _base_alist(tmp_path):
    path = tmp_path / "base.alist"
    jcodes.write_alist(code_pair("regular")[0], path)
    return path.read_text().splitlines()


def _mutated(kind, tmp_path):
    lines = _base_alist(tmp_path)
    n = int(lines[0].split()[0])
    if kind == "empty":
        return ""
    if kind == "three_lines":
        return "\n".join(lines[:3]) + "\n"
    if kind == "header_three_numbers":
        lines[0] += " 7"
    elif kind == "glued_sign":
        toks = lines[4].split()
        lines[4] = toks[0] + "+" + " ".join(toks[1:])
    elif kind == "junk_token":
        lines[5] += " x"
    elif kind == "float_token":
        lines[6] = lines[6].replace(" ", ".0 ", 1)
    elif kind == "column_count":
        lines[0] = f"{n + 1} {lines[0].split()[1]}"
    elif kind == "column_weight":
        w = lines[2].split()
        w[0] = str(int(w[0]) - 1)
        lines[2] = " ".join(w)
    elif kind == "declared_max":
        lines[1] = "1 1"
    elif kind == "truncated_body":
        lines = lines[:-2]
    elif kind == "index_out_of_range":
        row = lines[-1].split()
        row[-1] = str(n + 5)
        lines[-1] = " ".join(row)
    elif kind == "duplicate_edge":
        row = lines[-1].split()
        row[-1] = row[0]
        lines[-1] = " ".join(row)
    elif kind == "column_disagrees":
        a, b = lines[4].split(), lines[5].split()
        lines[4], lines[5] = " ".join(b), " ".join(a)
    return "\n".join(lines) + "\n"


MALFORMED = ["empty", "three_lines", "header_three_numbers", "glued_sign",
             "junk_token", "float_token", "column_count", "column_weight",
             "declared_max", "truncated_body", "index_out_of_range",
             "duplicate_edge", "column_disagrees"]


@pytest.mark.parametrize("kind", MALFORMED)
def test_malformed_alists_are_rejected_with_the_jax_packages_message(tmp_path, kind):
    text = _mutated(kind, tmp_path)
    with pytest.raises(ValueError) as j:
        jcodes.parse_alist(text, "bad.alist")
    with pytest.raises(ValueError) as t:
        tcodes.parse_alist(text, "bad.alist")
    assert str(t.value) == str(j.value)
    if tnative.native_available() and kind != "empty":
        p = tmp_path / "bad.alist"
        p.write_text(text)
        with pytest.raises(ValueError) as t_nat:
            tnative.read_alist_native(p)
        if jnative.native_available():
            with pytest.raises(ValueError) as j_nat:
                jnative.read_alist_native(p)
            assert str(t_nat.value) == str(j_nat.value)


def _qc_pair_on_disk(tmp_path):
    jc, tc = code_pair("qc")
    jp, tp = tmp_path / "j.alist", tmp_path / "t.alist"
    jcodes.write_alist(jc, jp)
    tcodes.write_alist(tc, tp)
    return jp, tp


@pytest.mark.parametrize("fault", ["corrupt", "z_divides_nothing", "stale"])
def test_bad_sidecars_raise_the_jax_packages_error(tmp_path, fault):
    jp, tp = _qc_pair_on_disk(tmp_path)
    if fault == "corrupt":
        text = "{not json"
    elif fault == "z_divides_nothing":
        text = '{"z": 7, "cells": [[0, 0, 1]]}'
    else:  # the sidecar of another lift of the same shape
        other = jcodes.make_qc_code(z=32, nb=12, mb=6, dv=3, seed=6)
        jcodes.write_alist(other, tmp_path / "other.alist")
        text = (tmp_path / "other.alist.qc.json").read_text()
    msgs = []
    for path, read in ((jp, jcodes.read_alist), (tp, tcodes.read_alist)):
        Path(str(path) + ".qc.json").write_text(text)
        with pytest.raises(ValueError) as e:
            read(path, native=False)
        msgs.append(str(e.value).replace(str(path), "<path>"))
    assert msgs[0] == msgs[1]


def test_writing_a_plain_code_over_a_qc_one_removes_its_sidecar(tmp_path):
    _, tp = _qc_pair_on_disk(tmp_path)
    _, plain = code_pair("regular")
    tcodes.write_alist(plain, tp)
    assert not tcodes.alist.qc_sidecar_path(tp).exists()
    assert tcodes.read_alist(tp).qc is None


def test_native_and_numpy_ingest_give_identical_arrays(tmp_path):
    if not tnative.native_available():
        pytest.skip(f"native library unavailable: {tnative.failure}")
    for which in ("regular", "irregular", "qc", "ragged"):
        jc, tc = code_pair(which)
        p = tmp_path / f"{which}.alist"
        tcodes.write_alist(tc, p)
        nat = tcodes.read_alist(p, native=True)
        assert_same_graph(nat, tcodes.read_alist(p, native=False))
        assert_same_graph(nat, jc)
        assert nat.qc == tc.qc
        neighbors = [tc.chk_adj[c, tc.chk_mask[c]] for c in range(tc.n_checks)]
        assert_same_graph(tcodes.from_check_adjacency(neighbors, tc.n_vars, native=True),
                          tcodes.from_check_adjacency(neighbors, tc.n_vars, native=False))
    ref = tcodes.read_alist(REFERENCE_ALIST, native=True)
    assert_same_graph(ref, jcodes.read_alist(REFERENCE_ALIST, native=False))
    assert ref.name == REFERENCE_ALIST.name
    # the library the port loads is its own build, named by the source's hash
    from qkd_ldpc_tpu_torch import _build

    assert _build.native_library_path().exists()
    assert _build.native_library_path().parent.name == "_build"


def test_native_true_raises_when_the_library_is_disabled(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_failed", False)
    monkeypatch.setattr(tnative, "failure", "")
    monkeypatch.setenv("QKD_LDPC_NO_NATIVE", "1")
    _, tc = code_pair("regular")
    p = tmp_path / "c.alist"
    tcodes.write_alist(tc, p)
    with pytest.raises(RuntimeError, match="Native alist loader unavailable"):
        tcodes.read_alist(p, native=True)
    assert_same_graph(tcodes.read_alist(p), tc)  # native=None falls back
    with pytest.raises(RuntimeError, match="Native graph builder unavailable"):
        tcodes.from_check_adjacency([np.array([0, 1])], 2, native=True)


def test_load_code_sniffs_and_listing_skips_sidecars(tmp_path):
    jc, tc = code_pair("qc")
    tcodes.write_alist(tc, tmp_path / "b_qc.alist")
    tcodes.write_dense(code_pair("regular")[1], tmp_path / "a_dense.txt")
    (tmp_path / "sub").mkdir()
    names = [p.name for p in tcodes.list_matrix_files(tmp_path)]
    assert names == [p.name for p in jcodes.list_matrix_files(tmp_path)]
    assert names == ["a_dense.txt", "b_qc.alist"]
    for name in names:
        assert_same_graph(tcodes.load_code(tmp_path / name),
                          jcodes.load_code(tmp_path / name))
    assert tcodes.load_code(tmp_path / "b_qc.alist").qc == tc.qc
    with pytest.raises(FileNotFoundError) as t:
        tcodes.list_matrix_files(tmp_path / "absent")
    with pytest.raises(FileNotFoundError) as j:
        jcodes.list_matrix_files(tmp_path / "absent")
    assert str(t.value) == str(j.value)
