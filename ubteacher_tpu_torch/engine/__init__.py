from .fcos_trainer import FCOSTrainState, make_fcos_train_steps

__all__ = ["FCOSTrainState", "make_fcos_train_steps"]
