from vsr_tpu_torch.train.losses import adversarial_loss
from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig, make_train_step

__all__ = ["adversarial_loss", "STTNTrainer", "TrainConfig", "make_train_step"]
