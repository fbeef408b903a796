"""UVR5 vocal separation / denoising (counterpart of ``lemas_tts_tpu/uvr5``).

The MDX-Net ``ConvTDFNet`` (``mdxnet.py``) behind the 4-channel real-STFT
packing and chunked overlap-trim demixing (``inference.py``), the VR-arch
cascades (``vr_network.py``, ``vr_legacy.py``) with their band-split spectrogram
chain (``spec_utils.py``, ``band_params.py``), in PyTorch. The modules and
their parameter names are the reference's, so reference ``.ckpt``/``.pth``
state dicts and ``.onnx`` initializers load with ``load_state_dict``.
"""

from lemas_tts_tpu_torch.uvr5.inference import UVR5, MDXSeparator

__all__ = ["UVR5", "MDXSeparator"]
