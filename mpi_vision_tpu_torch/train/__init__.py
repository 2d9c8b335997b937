"""Training of the port: VGG-perceptual loss, the Adam train step, the
mesh-sharded step and the epoch loops."""

from mpi_vision_tpu_torch.train.loop import (
    TrainState,
    create_train_state,
    fit,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    shard_train_step,
    shard_train_step_planned,
)
from mpi_vision_tpu_torch.train.loss import (
    l2_render_loss,
    render_novel_view,
    vgg_perceptual_loss,
)
from mpi_vision_tpu_torch.train.vgg import VGG16Features, imagenet_normalize
