"""The fast path's program cache (vinsat_tpu_torch/estimation/graphs.py):
programs are kept by key up to `MAX_PROGRAMS`, the least recently used
dropped first.  The programs here are stand-ins (the cache never looks
inside them); the captured programs themselves are held against their
eager runs on the card, in tests/test_torch_cuda.py.
"""
import collections

from vinsat_tpu_torch.estimation import graphs


def test_program_cache_drops_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    monkeypatch.setattr(graphs, "_programs", collections.OrderedDict())
    monkeypatch.setattr(graphs, "stats", collections.Counter())
    built = []

    def build(key):
        def make():
            built.append(key)
            return key.upper()
        return make

    for key in ["a", "b", "a", "c", "a", "b"]:
        assert graphs.program(key, build(key)) == key.upper()
        assert graphs.kept() <= 2
    # "a" stayed in use; "b" went when "c" came, and "c" when "b" came back
    assert built == ["a", "b", "c", "b"]
    assert graphs.stats["evictions"] == 2
    assert list(graphs._programs) == ["a", "b"]
    graphs.clear()
    assert graphs.kept() == 0
