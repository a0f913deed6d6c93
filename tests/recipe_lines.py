"""The recipes' command lines (``experiments/*.sh``) as argv lists, for the
port's tests and ``chip_smoke.py``.  Standard library only.

* ``recipe_lines()``: every ``python train.py`` / ``test.py`` line of
  ``experiments/*.sh``, continuation lines joined, as argv lists;
* ``with_flags(argv, **flags)``: ``argv`` with flags replaced or added;
* ``recipe_test_argv(recipe, **flags)``: a recipe's ``test.py`` argv,
  through ``with_flags``.
"""

from __future__ import annotations

import shlex
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parent.parent
RECIPES = {"mot": "mot17_tracking.sh", "kitti": "kitti_tracking.sh",
           "nuscenes": "nuScenes_3Dtracking.sh"}


def recipe_lines() -> Dict[Tuple[str, str, int], List[str]]:
    """{(recipe, script, index): argv} for each python line of the recipes
    (commented lines left out)."""
    out = {}
    for recipe, name in RECIPES.items():
        text = (ROOT / "experiments" / name).read_text()
        joined = text.replace("\\\n", " ")
        for i, line in enumerate(joined.splitlines()):
            words = shlex.split(line, comments=True)
            if len(words) >= 2 and words[0] == "python":
                out[(recipe, words[1], i)] = words[2:]
    return out


def with_flags(argv, **flags) -> List[str]:
    """``argv`` (as strings) with ``--name value`` flags replaced or
    appended; a value of True appends a bare flag."""
    argv = [str(a) for a in argv]
    for name, value in flags.items():
        flag = f"--{name}"
        if value is True:
            if flag not in argv:
                argv.append(flag)
        elif flag in argv:
            argv[argv.index(flag) + 1] = str(value)
        else:
            argv += [flag, str(value)]
    return argv


def recipe_test_argv(recipe: str, **flags) -> List[str]:
    """The recipe's ``test.py`` argv, through ``with_flags``."""
    (argv,) = [a for (r, script, _), a in recipe_lines().items()
               if r == recipe and script == "test.py"]
    return with_flags(argv, **flags)
