"""Every port test module runs on one intra-op thread, from one fixture.

``torch_threads.one_thread`` is the only place under ``tests/`` that
sets torch's thread count; each ``test_torch_*.py`` takes it with a
module-level ``from torch_threads import one_thread``. A module left
out runs its small tensor ops on every core while the other test
workers do the same, and slows down by an order of magnitude.
"""

import ast
from pathlib import Path

from torch_threads import one_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent


def takes_shared_fixture(tree: ast.Module) -> bool:
    """Whether the module imports ``one_thread`` from ``torch_threads``
    at its top level, under its own name."""
    return any(isinstance(node, ast.ImportFrom)
               and node.module == "torch_threads"
               and any(a.name == "one_thread" and a.asname is None
                       for a in node.names)
               for node in tree.body)


def sets_thread_count(tree: ast.Module) -> bool:
    """Whether the module names ``set_num_threads`` anywhere in its
    code (strings aside)."""
    return any(isinstance(node, ast.Attribute) and node.attr == "set_num_threads"
               or isinstance(node, ast.Name) and node.id == "set_num_threads"
               for node in ast.walk(tree))


def test_every_port_test_module_pins_one_thread():
    modules = sorted(TESTS.glob("test_torch_*.py"))
    assert len(modules) > 30, modules
    trees = {p.name: ast.parse(p.read_text(), str(p))
             for p in sorted(TESTS.glob("*.py"))}
    missing = [p.name for p in modules if not takes_shared_fixture(trees[p.name])]
    own = [name for name, tree in trees.items()
           if name != "torch_threads.py" and sets_thread_count(tree)]
    assert not missing, f"not taking torch_threads.one_thread: {missing}"
    assert not own, f"setting the thread count on their own: {own}"
