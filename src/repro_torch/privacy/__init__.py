"""Privacy evaluation of the port: the synthetic image set and SSIM."""
