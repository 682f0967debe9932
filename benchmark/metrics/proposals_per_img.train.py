"""proposals_per_img.train: the program's `proposals_kept` (RPN proposals
kept at train settings) summed over the window, over the student's images
of the window's iterations. Work a change takes away shows here, not as a
speed-up. None where the program counts no such scalar."""


def read(run):
    scalars = run.get("window_scalars")
    if not scalars or any("proposals_kept" not in s for s in scalars):
        return None
    return sum(s["proposals_kept"] for s in scalars) / (len(scalars) * run["student_images_per_iteration"])
