"""Paths in a captured model step, for the parallel-block tests: which
nodes apply a layer's attention output projection and its FFN down
product, and what a node reaches."""
from torch.utils import _pytree as pytree


def descendants(graph, name: str) -> set[str]:
    """Every node of ``graph`` reachable from ``name`` along its consumers
    (``name`` itself excluded)."""
    seen: set[str] = set()
    todo = list(graph.successors(name))
    while todo:
        n = todo.pop()
        if n not in seen:
            seen.add(n)
            todo.extend(graph.successors(n))
    return seen


def parallel_branches(captured, params) -> list[tuple[str, str]]:
    """For each layer of ``captured`` (a model step whose first argument is
    ``params``), in layer order: the node that reads
    ``layers[i]["attn"]["wo"]`` (the attention output projection) and the
    node that reads ``layers[i]["mlp"]["w_down"]`` (the FFN down product),
    found through the capture's map from argument leaf to input node.
    Raises if a weight has not one reader."""
    index = {id(t): j for j, t in enumerate(pytree.tree_leaves(params))}
    pairs = []
    for i, lp in enumerate(params["layers"]):
        found = []
        for what, w in (("attn wo", lp["attn"]["wo"]), ("mlp w_down", lp["mlp"]["w_down"])):
            users = captured.graph.successors(captured.input_names[index[id(w)]])
            if len(users) != 1:
                raise ValueError(f"layer {i}: {len(users)} nodes read its {what}, not one")
            found.append(users[0])
        pairs.append((found[0], found[1]))
    return pairs
