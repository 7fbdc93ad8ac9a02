"""Image-quality metrics of the port: PSNR, L1, SSIM (host numpy), LPIPS
(AlexNet, gated on a weights file) and the folder-against-folder harness
of `cli/metrics.py`. Port of `nerface_tpu/metrics/`."""

from nerface_tpu_torch.metrics.harness import ScalarMetric, two_folders
from nerface_tpu_torch.metrics.image import l1, psnr, ssim
from nerface_tpu_torch.metrics.lpips import LPIPSAlex, lpips_available

__all__ = ["l1", "psnr", "ssim", "ScalarMetric", "two_folders", "LPIPSAlex", "lpips_available"]
