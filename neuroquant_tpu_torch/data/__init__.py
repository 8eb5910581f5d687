from neuroquant_tpu_torch.data.videoset import VideoDataSet  # noqa: F401
