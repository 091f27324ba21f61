"""The second half of ``tests/test_torch_model_zoo.py``'s shape groups, and
every distinct model tree built at full size on the meta device (a file of
its own, so that the two halves run on two workers)."""

from tests.test_torch_model_zoo import GROUPS, HALF, build_every_tree, check_groups


def test_shape_groups_second_half():
    check_groups(GROUPS[HALF:])


def test_every_model_tree_builds_at_full_size():
    build_every_tree(GROUPS)
