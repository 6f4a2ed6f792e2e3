"""A tiny copy of a benchmark cell for the CPU tests: the cell's own
configuration with its widths and depth cut to a toy size. Cells whose
pieces exist but that BENCHMARK.json does not hold yet (`DRAFTS`) are
assembled from their files."""

from __future__ import annotations

import copy
import os

from perfbench import cell as cells

# cell -> (configuration, traffic mix) of the drafted cells (PERF.md, §7)
DRAFTS = {"phydiff-serve-bf16": ("phydiff", "open-loop-b16-bf16"),
          "srdiff-train-bf16": ("srdiff", "train-b16-bf16")}


def _cell(name: str) -> cells.Cell:
    try:
        return cells.find(name)
    except KeyError:
        if name not in DRAFTS:
            raise
    config, traffic = DRAFTS[name]
    load = cells.load_json
    return cells.Cell(name, load(os.path.join(cells.HERE, "configs", f"{config}.json")),
                      load(os.path.join(cells.HERE, "traffic", f"{traffic}.json")),
                      load(os.path.join(cells.HERE, "limits", f"{name}.json")), 1, [], [])


def tiny_cell(name: str, **traffic) -> cells.Cell:
    c = _cell(name)
    cfg = copy.deepcopy(c.config)
    m = cfg["model"]
    m["unet"].update(inner_channel=8, norm_groups=4, channel_multiplier=[1, 2], attn_res=[8],
                     res_blocks=1)
    m["diffusion"].update(image_height=16, image_width=32)
    if m.get("diffusion", {}).get("ddim_steps"):
        m["diffusion"]["ddim_steps"] = 3
    pre = m.setdefault("pretrained_model", {})
    pre.update(hidden_size=8, num_block=2)
    for sch in m["beta_schedule"].values():
        sch["n_timestep"] = 50
    tr = dict(c.traffic)
    tr.update(batch=2, lr_batches=2, pool=8, check_chains=2, traced_steps=1)
    tr.update(traffic)
    return cells.Cell(c.name, cfg, tr, c.limits, c.chips, c.end_to_end, c.per_layer)
