"""The party group's backend and device rule (``repro_torch.launch.mesh``):
``party_backend``, ``_rank_device`` and ``init_group`` with the card's
presence and count stubbed, ``torch.distributed``'s start and
``torch.cuda.set_device`` recorded instead of run. No group starts here.

  * 4 cards, 4 ranks: NCCL, each rank bound to ``cuda:LOCAL_RANK`` before
    the group starts, the group ``"cpu:gloo,cuda:nccl"`` (host operands
    over gloo);
  * 1 card, 4 ranks: gloo, every rank on ``cuda:0``, no binding;
  * the CPU: gloo; ``device=None`` without a card raises.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import mesh


@pytest.fixture
def card(monkeypatch):
    """``stub(n, local_rank)``: ``n`` visible cards, this rank's
    LOCAL_RANK; returns the list into which ``set_device`` and
    ``init_process_group`` calls are recorded, in order."""
    order = []

    def stub(n, local_rank=0):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))
        monkeypatch.setattr(torch.cuda, "set_device",
                            lambda d: order.append(("set_device",
                                                    torch.device(d))))
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: order.append(
                                ("init", backend, kw["rank"],
                                 kw["world_size"])))
        monkeypatch.setattr(dist, "get_world_size", lambda: 4)
        return order
    return stub


@pytest.mark.parametrize("local_rank", [0, 3])
def test_four_cards_four_ranks_take_nccl_one_card_a_rank(card, local_rank,
                                                         capsys):
    order = card(4, local_rank)
    assert mesh.party_backend(4) == ("nccl", torch.device("cuda",
                                                          local_rank))
    assert mesh.party_backend(4, "cuda") == mesh.party_backend(4)
    assert mesh.init_group(4, local_rank) == "nccl"
    # the card is bound before the group starts (and its communicators)
    assert order == [("set_device", torch.device("cuda", local_rank)),
                     ("init", mesh.NCCL_GROUP, local_rank, 4)]
    assert mesh.NCCL_GROUP == "cpu:gloo,cuda:nccl"
    assert mesh._rank_device("nccl", None) == torch.device("cuda",
                                                           local_rank)
    assert order[-1] == ("set_device", torch.device("cuda", local_rank))
    # a group the rule would not start is refused
    with pytest.raises(RuntimeError, match="rule gives nccl"):
        mesh._rank_device("gloo", "cuda")
    out = capsys.readouterr().out
    assert ("backend nccl (4 GPUs visible" in out) == (local_rank == 0)


def test_fewer_cards_than_ranks_share_cuda0_over_gloo(card):
    order = card(1, 2)
    assert mesh.party_backend(4) == ("gloo", torch.device("cuda", 0))
    assert mesh.init_group(4, 2, "cuda") == "gloo"
    assert order == [("init", "gloo", 2, 4)]
    assert mesh._rank_device("gloo", None) == torch.device("cuda", 0)
    assert order == [("init", "gloo", 2, 4)]          # nothing bound


def test_cpu_takes_gloo(card):
    order = card(0)
    assert mesh.party_backend(4, "cpu") == ("gloo", torch.device("cpu"))
    assert mesh.init_group(4, 1, "cpu") == "gloo"
    assert order == [("init", "gloo", 1, 4)]
    assert mesh._rank_device("gloo", "cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.party_backend(4)


def test_backend_name_reads_the_nccl_group(monkeypatch):
    """The NCCL group's backend string names both halves; the party group
    and the mesh report it as "nccl"."""
    for got, want in ((mesh.NCCL_GROUP, "nccl"), ("gloo", "gloo")):
        monkeypatch.setattr(dist, "get_backend", lambda g=None, b=got: b)
        assert mesh._backend_name() == want
