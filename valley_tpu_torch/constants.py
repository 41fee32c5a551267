"""Special tokens and shared constants.

The PyTorch port's own copy of ``valley_tpu/constants.py`` (numpy only, no
jax), so that the port imports nothing of the JAX package.

Parity with the reference's `valley/util/config.py:1-13` and
`valley/constants.py:1-4` (serve heartbeat constants).
"""

IGNORE_INDEX = -100

DEFAULT_PAD_TOKEN = "[PAD]"
DEFAULT_EOS_TOKEN = "</s>"
DEFAULT_BOS_TOKEN = "</s>"
DEFAULT_UNK_TOKEN = "<unk>"

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VIDEO_FRAME_TOKEN = "<vi_frame>"
DEFAULT_VI_START_TOKEN = "<vi_start>"
DEFAULT_VI_END_TOKEN = "<vi_end>"

# Serving control-plane timing (reference `valley/constants.py`).
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15
LOGDIR = "."

# Number of spatial patch tokens a 224x224 image contributes after the
# ViT-L/14 patchify: (224/14)**2.  The reference hardcodes 256 in several
# places (`valley_model.py:192,387`, `dataset.py:73-75`); here it is derived
# from the vision config but this module-level value is the canonical default.
DEFAULT_NUM_PATCHES = 256
# Default number of uniformly sampled video frames (`data_util.py:253`).
DEFAULT_NUM_FRAMES = 8
