"""Config system: commented-JSON experiment configs and experiment scaffolding."""
