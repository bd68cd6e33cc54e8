"""train_tokens_per_s: the training tokens of every step of the window over
the window (which ends with the step that ends past the window's seconds)."""


def read(raw):
    if not raw.get("steps"):
        return None
    return raw["steps"] * raw["tokens_per_step"] / raw["window_s"]
