from repro_torch.checkpoint.io import (latest_step, load_checkpoint,
                                       load_state, save_checkpoint,
                                       save_state)

__all__ = ["latest_step", "load_checkpoint", "load_state",
           "save_checkpoint", "save_state"]
