"""train_img_s: every image (labeled and unlabeled) of the mutual
iterations that ended in the window, over the window's seconds (host clock;
the window ends at an iteration's end)."""


def read(run):
    periods = run.get("periods_s")
    if not periods:
        return None
    return len(periods) * run["images_per_iteration"] / run["window_s"]
