"""The dry run (``launch/dryrun_lib.py``'s ``lower_cell`` / ``run_cells``
and ``launch/dryrun.py``'s CLI) on the CPU.

Every one of the 80 cells (10 archs × 4 shapes × the 16×16 and 2×16×16
meshes) gets its status and reason: each cell at a cut depth (one period:
the status and the reason do not depend on the depth), the skipped ones
with the reference's reason word for word, every other cell ``ok`` (the
train cells of every family since the train step runs each on a mesh),
none an ``error``.  ``run_cells`` keeps its cache as the reference does,
and the CLI writes no file unless given ``--out``.
"""
import dataclasses
import json

import pytest

from repro_torch.configs import LM_SHAPES, get_config, list_archs
from repro_torch.launch import dryrun, dryrun_lib
from repro_torch.models import decoder
from test_torch_x64_shim import x64_shim

DENSE = ("qwen3-1.7b", "yi-6b", "internlm2-20b", "qwen3-32b")


@pytest.fixture(scope="module")
def jconfigs():
    with x64_shim():
        import repro.configs

    return repro.configs


@pytest.fixture(scope="module")
def cells():
    """Every cell of both meshes at one period's depth."""
    out = {}
    for multi in (False, True):
        for arch in list_archs():
            cfg = get_config(arch)
            cut = dataclasses.replace(cfg, num_layers=decoder.period_len(cfg))
            for shape in LM_SHAPES:
                out[arch, shape.name, multi] = dryrun_lib.lower_cell(arch, shape.name, multi_pod=multi, cfg=cut)
    return out


def test_every_cell_has_its_status_and_reason(cells, jconfigs):
    assert len(cells) == 80
    for (arch, shape, multi), res in cells.items():
        ok, reason = jconfigs.get_config(arch).shape_supported(jconfigs.SHAPES_BY_NAME[shape])
        assert res.arch == arch and res.shape == shape
        assert res.mesh == ("multi(2x16x16)" if multi else "single(16x16)")
        if not ok:
            assert (res.status, res.reason) == ("skipped", reason)
        else:
            assert res.status == "ok", (arch, shape, multi, res.reason)
            assert res.reason == "" and res.roofline["chips"] == (512 if multi else 256)
    counts = {st: sum(r.status == st for r in cells.values()) for st in ("ok", "skipped", "error")}
    assert counts == {"ok": 64, "skipped": 16, "error": 0}
    trains = [k for k in cells if k[1] == "train_4k" and k[0] not in DENSE]
    assert len(trains) == 12 and all(cells[k].status == "ok" for k in trains)


def test_a_cell_result_keeps_the_reference_fields(cells):
    fields = {"arch", "shape", "mesh", "status", "reason", "compile_s", "memory", "cost_analysis", "roofline",
              "collectives"}
    res = cells["qwen3-32b", "decode_32k", True]
    assert set(res.to_json()) == fields
    assert json.loads(json.dumps(res.to_json()))["roofline"]["dominant"] in ("compute", "memory", "collective")


def _fake_lower(calls):
    def lower_cell(arch, shape_name, *, multi_pod=False, perf=None):
        calls.append((arch, shape_name, multi_pod))
        status = {"a": "ok", "b": "skipped", "c": "error"}[arch]
        return dryrun_lib.CellResult(arch, shape_name, "multi" if multi_pod else "single", status,
                                     reason="" if status == "ok" else status)
    return lower_cell


def test_run_cells_caches_ok_and_skipped_cells(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(dryrun_lib, "lower_cell", _fake_lower(calls))
    out = tmp_path / "dry.json"
    cells_ = [("a", "train_4k", False), ("b", "long_500k", True), ("c", "decode_32k", False)]
    first = dryrun_lib.run_cells(cells_, str(out))
    assert [r.status for r in first] == ["ok", "skipped", "error"] and len(calls) == 3
    saved = json.loads(out.read_text())
    assert set(saved) == {"a|train_4k|single|baseline", "b|long_500k|multi|baseline", "c|decode_32k|single|baseline"}
    second = dryrun_lib.run_cells(cells_, str(out))
    assert [r.to_json() for r in second] == [r.to_json() for r in first]
    assert calls[3:] == [("c", "decode_32k", False)]            # only the error is counted again
    dryrun_lib.run_cells(cells_[:1], str(out), tag="other")
    assert calls[-1] == ("a", "train_4k", False)                # another tag is another cell
    assert "[ok     ] a × train_4k × single" in capsys.readouterr().err


def test_cli_writes_nothing_without_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(dryrun_lib, "lower_cell", _fake_lower(calls))
    assert dryrun.main(["--arch", "a", "--shape", "train_4k"]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "ok"
    assert dryrun.main(["--arch", "c", "--shape", "train_4k", "--mesh", "both"]) == 1
    assert [r["mesh"] for r in json.loads(capsys.readouterr().out)] == ["single", "multi"]
    assert list(tmp_path.iterdir()) == []
    assert dryrun.main(["--arch", "a", "--shape", "train_4k", "--out", "res/one.json"]) == 0
    assert json.loads((tmp_path / "res" / "one.json").read_text())["status"] == "ok"


def test_cli_all_prints_every_cell_and_exits_one_on_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dryrun_lib, "lower_cell", lambda arch, shape, *, multi_pod=False, perf=None: (
        dryrun_lib.CellResult(arch, shape, "m", "error" if arch == "yi-6b" else "ok")))
    assert dryrun.main(["--all", "--mesh", "both"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert len(got) == 80 and sum(v["status"] == "error" for v in got.values()) == 8
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "yi-6b"])


@pytest.mark.parametrize("multi", (False, True), ids=("single", "multi"))
def test_dense_decode_cells_split_the_cache_over_model_under_the_flag(multi):
    """``--perf '{"shard_cache_seq_over_model": true}'``: every dense
    decoder's decode cell is ``ok``, and a rank's KV block holds its share
    of the sequence (every KV head), as the reference's
    ``P(None, batch, "model", None, None)`` places it."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.configs.perf import PerfConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model_zoo as zoo

    perf = PerfConfig(shard_cache_seq_over_model=True)
    shape = SHAPES_BY_NAME["decode_32k"]
    mesh = make_production_mesh(multi_pod=multi)
    for arch in DENSE:
        cfg = get_config(arch)
        cut = dataclasses.replace(cfg, num_layers=decoder.period_len(cfg))
        res = dryrun_lib.lower_cell(arch, shape.name, multi_pod=multi, perf=perf, cfg=cut)
        assert res.status == "ok", (arch, res.reason)
        spec = dryrun_lib.batch_pspecs(cfg, shape, mesh, perf)["state"].caches["pos0"].k
        assert spec[2] == "model", spec
        rows = shape.global_batch // (32 if multi else 16)          # over (pod, data)
        with shd.use_sharding(mesh, dryrun_lib.perf_rules(perf)):
            layout = zoo.serving_layout(cut, perf, dryrun_lib.dry_mesh(mesh))
            state = decoder.init_decode_state(cut, rows, shape.seq_len, device="meta", layout=layout)
        assert tuple(state.caches[0]["pos0"].k.shape) == (rows, shape.seq_len // 16, cfg.num_kv_heads,
                                                          cfg.head_dim), arch
