from lemas_tts_tpu_torch.eval.metrics import (
    cer,
    mcd,
    mel_mae,
    mel_mse,
    speaker_similarity,
    spectral_distance,
    wer,
)

__all__ = ["mel_mse", "mel_mae", "spectral_distance", "mcd", "speaker_similarity", "wer",
           "cer"]
