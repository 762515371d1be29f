from posetraj_torch.train.checkpoints import export_diffusers, latest_checkpoint, restore_checkpoint, save_checkpoint
from posetraj_torch.train.trainer import (
    MicroStepGraph,
    Trainer,
    TrainState,
    draw_step_randoms,
    edm_training_loss,
    encode_image_clip_train,
    make_optimizer,
    micro_step,
    train_step,
)

__all__ = ["MicroStepGraph", "Trainer", "TrainState", "draw_step_randoms", "edm_training_loss",
           "encode_image_clip_train", "export_diffusers", "latest_checkpoint", "make_optimizer", "micro_step",
           "restore_checkpoint", "save_checkpoint", "train_step"]
