"""The port's paper-network graph constructors (Table 1) against the JAX
package's: the same nodes in the same order, with the same kinds, deps,
flops, bytes and meta, for every net, size and mode.  They are exact
arithmetic on the same integers: no tolerance."""
import pytest

from repro.models import paper_nets as j_nets
from repro_torch.models import paper_nets as t_nets


def _nodes(g):
    return [(n.name, n.kind, n.flops, n.bytes_in, n.bytes_out, n.deps, dict(n.meta))
            for n in g.nodes]


def test_tables_match_reference():
    assert t_nets.PAPER_NETS == j_nets.PAPER_NETS
    assert t_nets.PAPER_SIZES == j_nets.PAPER_SIZES
    assert t_nets.PAPER_BATCH == j_nets.PAPER_BATCH
    assert (t_nets.LSTM_LAYERS, t_nets.LSTM_VOCAB) == (j_nets.LSTM_LAYERS, j_nets.LSTM_VOCAB)
    assert t_nets.__all__ == j_nets.__all__


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("size", ["small", "medium", "large"])
@pytest.mark.parametrize("net", j_nets.PAPER_NETS)
def test_paper_graph_matches_reference(net, size, training):
    jg = j_nets.paper_graph(net, size, training=training)
    g = t_nets.paper_graph(net, size, training=training)
    assert g.name == jg.name
    assert _nodes(g) == _nodes(jg)
    g.validate()


@pytest.mark.parametrize("make", ["lstm_forward_graph", "pathnet_forward_graph",
                                  "googlenet_forward_graph"])
def test_forward_graphs_take_a_batch(make):
    jg = getattr(j_nets, make)("small", batch=8)
    g = getattr(t_nets, make)("small", batch=8)
    assert _nodes(g) == _nodes(jg)


def test_phased_lstm_and_training_ratio_match_reference():
    jf = j_nets.lstm_forward_graph("medium", phased=True)
    f = t_nets.lstm_forward_graph("medium", phased=True)
    assert _nodes(f) == _nodes(jf)
    assert (_nodes(t_nets.training_graph(f, bwd_flops_ratio=3.0))
            == _nodes(j_nets.training_graph(jf, bwd_flops_ratio=3.0)))


def test_unknown_net_raises_like_reference():
    with pytest.raises(ValueError, match="unknown paper net"):
        j_nets.paper_graph("resnet", "small")
    with pytest.raises(ValueError, match="unknown paper net"):
        t_nets.paper_graph("resnet", "small")
