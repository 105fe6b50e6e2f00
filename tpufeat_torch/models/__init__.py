"""The ASR models fed by the front-end (config 5): encoders, CTC and RNN-T
training steps and decoders, and x-vector speaker embeddings."""
