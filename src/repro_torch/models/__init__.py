"""Dense LM stack (the serving slice of ``repro.models``)."""
