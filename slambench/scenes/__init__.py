"""The benchmark's frames: frozen copies of kintinuous_tpu_torch/io/synth.py's
scenes (as data, `<scene>.json`), trajectories (`trajectories.py`) and
structured-light sensor renderer, rewritten in PyTorch so that a run
renders its frames on the card from its seed (`render.py`)."""
