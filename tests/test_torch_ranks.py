"""The multi-rank runtime (``repro_torch.distributed.ranks``) on the CPU: the
collectives against their definitions, the mesh's process groups and
coordinates, and that no rank failure can hang or pass silently — a rank
that raises, dies or outlives the timeout makes the spawn raise, and two
spawns at once in one process do not collide (a fresh ``FileStore`` each,
no fixed port)."""
import os
import threading
import time

import pytest
import torch

from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_rank_mesh


def _collectives() -> dict:
    r = ranks.rank()
    mesh = make_rank_mesh((2, 2), ("data", "model"))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    out = {
        "rank": r,
        "coordinate": mesh.coordinate,
        "index": (mesh.index("data"), mesh.index("model"), mesh.index(("data", "model"))),
        "psum_model": ranks.psum(x, "model", mesh),
        "psum_both": ranks.psum(x, ("data", "model"), mesh),
        "pmean_data": ranks.pmean(x, "data", mesh),
        "psum_bf16": ranks.psum(x.to(torch.bfloat16), "model", mesh),
        "gather_model_1": ranks.all_gather(x, "model", 1, mesh),
        "gather_both_0": ranks.all_gather(x, ("data", "model"), 0, mesh),
        "gather_bool": ranks.all_gather(x > 12, "data", 0, mesh),
        "gather_bf16": ranks.all_gather(x.to(torch.bfloat16), "model", 1, mesh),
        "gather_zeros": ranks.all_gather(_signed(r), ("data", "model"), 0, mesh),
        "a2a": ranks.all_to_all(torch.arange(4, dtype=torch.int64).reshape(2, 2) + 100 * r, "model", 0, 1, mesh),
        "a2a_back": ranks.all_to_all(
            ranks.all_to_all(x.reshape(2, 3, 1).expand(2, 3, 2).contiguous(), "model", 0, 1, mesh),
            "model", 1, 0, mesh),
        "shard": ranks.shard(torch.arange(24).reshape(4, 6), shd.P("data", "model"), mesh),
        "info": ranks.info(),
        "outside": make_rank_mesh((3,), ("fleet",)).coordinate,
    }
    whole = torch.arange(24).reshape(4, 6)
    out["unshard"] = torch.equal(ranks.unshard(ranks.shard(whole, shd.P("data", "model"), mesh),
                                               shd.P("data", "model"), mesh), whole)
    return out


def _signed(r):
    """Negative and positive zeros, a NaN and infinities: a gather moves
    their bits."""
    return torch.tensor([-0.0, 0.0, float("nan"), -float("inf"), float(r)], dtype=torch.float64)


@pytest.fixture(scope="module")
def four():
    """Every rank's result of :func:`_collectives` (rank 0 gathers them)."""
    return ranks.spawn(4, _gather_all, device="cpu", timeout_s=120)


def _gather_all():
    import torch.distributed as dist

    mine = _collectives()
    every = [None] * ranks.world_size()
    dist.all_gather_object(every, mine)
    return every


def test_mesh_coordinates_and_groups(four):
    for r, got in enumerate(four):
        assert got["rank"] == r
        assert got["coordinate"] == (r // 2, r % 2)
        assert got["index"] == (r // 2, r % 2, r)
        assert got["outside"] == ((r,) if r < 3 else None)
        assert got["info"]["ranks"] == 4 and got["info"]["backend"] == "gloo" and got["info"]["staged"] == "host"


def test_reductions_are_lax_psum_and_pmean(four):
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r for r in range(4)]
    for r, got in enumerate(four):
        row = r // 2
        assert torch.equal(got["psum_model"], xs[2 * row] + xs[2 * row + 1])
        assert torch.equal(got["psum_both"], sum(xs))
        assert torch.equal(got["pmean_data"], (xs[r % 2] + xs[2 + r % 2]) / 2)
        want = (xs[2 * row].to(torch.bfloat16).float() + xs[2 * row + 1].to(torch.bfloat16).float())
        assert got["psum_bf16"].dtype == torch.bfloat16
        assert torch.equal(got["psum_bf16"], want.to(torch.bfloat16))


def test_gathers_and_all_to_all_move_bits(four):
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r for r in range(4)]
    for r, got in enumerate(four):
        row = r // 2
        assert torch.equal(got["gather_model_1"], torch.cat([xs[2 * row], xs[2 * row + 1]], 1))
        assert torch.equal(got["gather_both_0"], torch.cat(xs, 0))
        assert torch.equal(got["gather_bool"], torch.cat([xs[r % 2] > 12, xs[2 + r % 2] > 12], 0))
        assert got["gather_bf16"].dtype == torch.bfloat16
        assert torch.equal(got["gather_bf16"], torch.cat([xs[2 * row], xs[2 * row + 1]], 1).to(torch.bfloat16))
        # tiled all_to_all: block j of the split dim to member j, the blocks
        # received concatenated in the senders' order
        peers = [2 * row, 2 * row + 1]
        sent = [torch.arange(4, dtype=torch.int64).reshape(2, 2) + 100 * p for p in peers]
        assert torch.equal(got["a2a"], torch.cat([s[r % 2: r % 2 + 1] for s in sent], 1))
        assert torch.equal(got["a2a_back"], xs[r].reshape(2, 3, 1).expand(2, 3, 2))
        assert torch.equal(got["shard"], torch.arange(24).reshape(4, 6)[2 * row:2 * row + 2,
                                                                       3 * (r % 2):3 * (r % 2) + 3])
        assert got["unshard"]
        assert torch.equal(got["gather_zeros"].view(torch.int64), torch.cat([_signed(k) for k in range(4)]).view(torch.int64))


def _raise_in_rank_1():
    if ranks.rank() == 1:
        raise ValueError("planted failure in rank one")
    import torch.distributed as dist

    dist.barrier()              # rank 0 would wait here forever without the teardown
    return "unreachable"


def _die_in_rank_1():
    if ranks.rank() == 1:
        os._exit(3)
    import torch.distributed as dist

    dist.barrier()


def _sleep_long():
    time.sleep(60)


def _rank_and_world(tag):
    import torch.distributed as dist

    t = torch.tensor([ranks.rank()])
    dist.all_reduce(t)
    return tag, ranks.world_size(), int(t)


def test_a_rank_that_raises_fails_the_spawn_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(ranks.RankError, match="rank 1 of 2 failed") as e:
        ranks.spawn(2, _raise_in_rank_1, device="cpu", timeout_s=60)
    assert "planted failure in rank one" in str(e.value) and "_raise_in_rank_1" in str(e.value)
    assert time.monotonic() - t0 < 60


def test_a_rank_that_dies_or_hangs_fails_the_spawn():
    with pytest.raises(ranks.RankError, match="rank 1 of 2 died with exit code 3"):
        ranks.spawn(2, _die_in_rank_1, device="cpu", timeout_s=60)
    t0 = time.monotonic()
    with pytest.raises(ranks.RankError, match="did not finish within 6"):
        ranks.spawn(1, _sleep_long, device="cpu", timeout_s=6)
    assert time.monotonic() - t0 < 20


def test_two_spawns_at_once_do_not_collide():
    got = {}

    def run(tag, n):
        got[tag] = ranks.spawn(n, _rank_and_world, tag, device="cpu", timeout_s=120)

    threads = [threading.Thread(target=run, args=(tag, n)) for tag, n in (("a", 2), ("b", 3))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == {"a": ("a", 2, 1), "b": ("b", 3, 3)}


def test_spawn_refuses_the_card_without_one_and_meshes_need_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ranks.spawn(2, _rank_and_world, "x")
    with pytest.raises(ValueError, match=r"needs 4 ranks but 1 is running"):
        make_rank_mesh((2, 2))
    with pytest.raises(ValueError, match="at least one rank"):
        ranks.spawn(0, _rank_and_world, "x", device="cpu")
    one = make_rank_mesh((1, 1))
    assert one.is_member and one.size == 1 and ranks.psum(torch.ones(2), "model", one).tolist() == [1.0, 1.0]
    assert ranks.info() == {"ranks": 1, "backend": "gloo", "staged": "host", "ranks_per_card": None,
                            "spawn_s": 0.0}
    with pytest.raises(RuntimeError, match="only defined inside spawn"):
        ranks.device()
