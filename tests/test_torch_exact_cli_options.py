"""The port's CLI without ``--fast`` against the JAX CLI with the exact
chain's options ``--no-quirks`` (chunk-size invariant) and ``--timebase
integer`` (exact n*Ts timestamps, implies ``--no-quirks``), on the
4-frame POES WAV of ``tests/test_torch_exact_cli.py`` and under its
tolerance (``docs/DESIGN.md`` §4b).
"""

import pytest

from test_torch_exact_cli import check_lines, poes_wav, run_both  # noqa: F401


@pytest.mark.parametrize("opts", [["--no-quirks"], ["--timebase", "integer"]])
def test_exact_cli_options_match_jax_cli(poes_wav, opts, tmp_path,
                                         monkeypatch, capsys):
    j, t, _, _ = run_both(poes_wav, opts, tmp_path, monkeypatch, capsys)
    check_lines(j, t)
