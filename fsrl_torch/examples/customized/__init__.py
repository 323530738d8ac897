"""Hand-assembled training loops (port of ``examples/customized/*``): each
script builds its algorithm, env, rollout and (off-policy) replay buffer
itself and owns its collect, update, evaluation and logging cadence, with
no agent and no trainer. Run one as a module:

    python -m fsrl_torch.examples.customized.train_ppol [--flag value ...]
    python -m fsrl_torch.examples.customized.eval_ppol --path <run directory>

Flags are the fields of the script's config dataclass; ``--device cpu``
runs on the CPU (the default is CUDA, which the scripts require
otherwise)."""
