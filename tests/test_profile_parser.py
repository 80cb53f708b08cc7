"""The render-profile parser (config.parse_profile_text) against PyYAML.

The renderer reads profiles without PyYAML; on the subset it accepts it must
agree with ``yaml.safe_load``, and anything outside the subset must fail
with a ValueError (the CLI turns that into exit code 2).
"""
import re
from pathlib import Path

import pytest

from path_tracer_tpu.config import Profile, parse_profile_text

README = Path(__file__).resolve().parents[1] / "README.md"

VARIANTS = {
    "block_resolution": "resolution:\n  width: 96   # w\n  height: 72\n"
                        "samples: 8\nbounces: 4\n",
    "flow_resolution": "resolution: {width: 800, height: 600}\n"
                       "tonemap: ACES\n",
    "quotes_and_null": "---\nseed: null\nbrdf: 'COOK_TORRANCE'\n"
                       "tonemap: \"REINHARD\"\nsamples: +5\n",
    "comments_only": "# nothing but a comment\n\n",
    "empty_and_tilde": "alpha_walk_steps:\nshadow_walk_steps: ~\n",
}


def _yaml():
    return pytest.importorskip("yaml")


def test_readme_profile_matches_yaml():
    text = re.search(r"```yaml\n(.*?)```", README.read_text(), re.S).group(1)
    assert parse_profile_text(text) == _yaml().safe_load(text)
    Profile.from_dict(parse_profile_text(text))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_profile_variants_match_yaml(name):
    text = VARIANTS[name]
    assert parse_profile_text(text) == (_yaml().safe_load(text) or {})


@pytest.mark.parametrize("text", [
    "samples:\n  - 1\n  - 2\n",
    "[1, 2]\n",
    "resolution: [1920, 1080]\n",
    "  samples: 4\n",
], ids=["block_list", "top_level_list", "flow_list", "stray_indent"])
def test_unsupported_syntax_raises(text):
    with pytest.raises(ValueError):
        parse_profile_text(text)


def test_bad_profile_exits_2(tmp_path, capsys):
    from path_tracer_tpu import cli

    prof = tmp_path / "p.yaml"
    prof.write_text("samples:\n  - 1\n")
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "missing.isf", "-p", str(prof), "-q"])
    assert e.value.code == 2
    assert "line 2" in capsys.readouterr().err
