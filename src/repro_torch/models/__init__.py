"""LM stack: the dense and xLSTM families of ``repro.models``."""
