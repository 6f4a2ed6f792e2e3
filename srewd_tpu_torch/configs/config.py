"""Experiment configuration: commented-JSON parsing and the experiment dir layout.

The port's own copy of srewd_tpu/configs/config.py, same schema:
  * JSON files may carry '//' line comments, stripped per line;
  * an experiment run creates experiments/<name>_<yymmdd_HHMMSS>/
    {logs, tb_logger, results, checkpoint}; when `path.resume_state` is set
    the experiment root is re-derived from it, and `"auto"` resumes the
    newest `I{iter}_E{epoch}` checkpoint of this experiment name;
  * `data.transform_groups` is flattened from a named dict to a list of
    month groups.
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import OrderedDict
from datetime import datetime


def load_commented_json(path: str) -> OrderedDict:
    """Parse JSON allowing '//' line comments."""
    json_str = ""
    with open(path) as f:
        for line in f:
            json_str += line.split("//")[0] + "\n"
    return json.loads(json_str, object_pairs_hook=OrderedDict)


def _now_tag() -> str:
    return datetime.now().strftime("%y%m%d_%H%M%S")


class Config:
    """Load an experiment config and (optionally) create its directory tree."""

    def __init__(self, config_path: str, phase: str | None = None, experiment: bool = True):
        self.root = config_path
        self.params = load_commented_json(config_path)
        if phase:
            self.params["phase"] = phase
        self.experiments_root = None
        if experiment:
            self._handle_experiment_dirs()
        tg = self.params.get("data", {}).get("transform_groups")
        if isinstance(tg, dict):
            self.params["data"]["transform_groups"] = list(tg.values())

    def _find_latest_checkpoint(self) -> str | None:
        """Newest I{iter}_E{epoch} checkpoint across this experiment name's runs."""
        base = self.params.get("path", {}).get("experiments_folder_path") or "."
        pattern = os.path.join(
            base, "experiments", f"{self.params['name']}_*", "checkpoint", "I*_E*"
        )
        # anchored run-dir match, <name>_<yymmdd_HHMMSS> exactly: a bare prefix
        # glob would also match sibling experiments whose name extends this one
        run_re = re.compile(rf"^{re.escape(self.params['name'])}_\d{{6}}_\d{{6}}$")
        best, best_iter = None, -1
        for p in glob.glob(pattern):
            run_dir = os.path.basename(os.path.dirname(os.path.dirname(p)))
            if not run_re.match(run_dir):
                continue
            m = re.match(r"I(\d+)_E(\d+)$", os.path.basename(p))
            if m and int(m.group(1)) > best_iter:
                best, best_iter = p, int(m.group(1))
        return best

    def _handle_experiment_dirs(self) -> None:
        paths = self.params.get("path", {})
        resume = paths.get("resume_state")
        if resume == "auto":
            resume = self._find_latest_checkpoint()
            paths["resume_state"] = resume  # None -> fresh run below
        if not resume:
            base = paths.get("experiments_folder_path") or "."
            self.experiments_root = os.path.join(
                base, "experiments", f"{self.params['name']}_{_now_tag()}"
            )
        else:
            # resume_state points at .../experiments/<run>/checkpoint/<ckpt>
            self.experiments_root = os.path.dirname(os.path.dirname(os.path.abspath(resume)))
        for key, sub in list(paths.items()):
            if key.startswith("resume") or key.startswith("experiments"):
                continue
            paths[key] = os.path.join(self.experiments_root, sub)
            os.makedirs(paths[key], exist_ok=True)
        paths["experiments_root"] = self.experiments_root

    def get_opt(self) -> dict:
        return self.params


def dict2str(opt: dict, indent_l: int = 1) -> str:
    """Config pretty-printer for the log file."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg
