"""The disk guard of the port's tests (tests/torch_parity.py): a temp dir
over TMP_BUDGET fails and names its largest files, one under it passes, and
remove_large_files deletes checkpoint-sized files and keeps the small ones
a reader debugs from."""

import pytest

from torch_parity import (  # noqa: F401 (tmp_budget: an autouse fixture)
    LARGE_FILE,
    TMP_BUDGET,
    check_tmp_budget,
    remove_large_files,
    tmp_budget,
    tmp_footprint,
)


def _write(path, n_bytes):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x01" * n_bytes)


@pytest.mark.parametrize("mib,over", [(70, True), (1, False)])
def test_budget_fails_over_and_names_the_file(tmp_path, mib, over):
    root = tmp_path / "left"
    big = root / "checkpoints" / "4"
    try:
        _write(big, mib << 20)
        _write(root / "metrics.json", 100)
        assert tmp_footprint(root) == ((mib << 20) + 100, [(mib << 20, "checkpoints/4"), (100, "metrics.json")])
        if over:
            assert (mib << 20) > TMP_BUDGET
            with pytest.raises(pytest.fail.Exception, match=r"over the budget .* checkpoints/4 \(70\.0 MiB\)"):
                check_tmp_budget(root)
        else:
            check_tmp_budget(root)
    finally:
        big.unlink()


def test_remove_large_files_keeps_the_small_ones(tmp_path):
    _write(tmp_path / "out" / "checkpoints" / "2", LARGE_FILE)
    _write(tmp_path / "rank0.pt", 3 * LARGE_FILE)
    _write(tmp_path / "out" / "metrics.json", 2000)
    _write(tmp_path / "out" / "log.txt", LARGE_FILE - 1)
    remove_large_files(tmp_path)
    assert tmp_footprint(tmp_path) == (LARGE_FILE + 1999, [(LARGE_FILE - 1, "out/log.txt"),
                                                           (2000, "out/metrics.json")])
    assert (tmp_path / "out" / "checkpoints").is_dir()
