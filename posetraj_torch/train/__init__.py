from posetraj_torch.train.trainer import (
    Trainer,
    TrainState,
    draw_step_randoms,
    edm_training_loss,
    encode_image_clip_train,
    make_optimizer,
    train_step,
)

__all__ = ["Trainer", "TrainState", "draw_step_randoms", "edm_training_loss", "encode_image_clip_train",
           "make_optimizer", "train_step"]
