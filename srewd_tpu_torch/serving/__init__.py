"""Serving layer of the port (twin of srewd_tpu/serving): a persistent
batched sampler service (`serving.service.SamplerService`), its stdlib HTTP
front end (`serving.http.make_server`) and the exported, self-contained
sampler (`serving.export`: `export_sampler`, `save_sampler`,
`load_sampler`). Entry points: `python -m srewd_tpu_torch.serve`,
`.export_sampler` and `.bench_serve`.

This package module imports nothing, so that loading an artifact
(`serving.export.load_sampler`) pulls in no model code.
"""
