"""DeepFilterNet-class denoiser (inference): ``model`` and the shipped
weights of both variants (``train.load_pretrained``)."""
