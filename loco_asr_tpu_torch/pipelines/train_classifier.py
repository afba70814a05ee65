"""Train the SLURP intent classifier on cached SpeechT5 embeddings on the
GPU: the port of ``loco_asr_tpu.pipelines.train_classifier``.

Same flags as the JAX pipeline, plus ``--device`` (default cuda; cpu runs
on the CPU):
  --modality/-m {text,audio}  --pooling/-p {average,max,attention}
  --version/-v {fine_tuned,base}  --folder  --batch_size  --epochs  --lr
  --weight_decay  --patience  --print_every  --seed  --parity_pooling
  --embedding_size  --num_classes  --hidden_dims
Reference hyperparameters as defaults: batch 16, Adam lr 1e-3 with L2
weight decay 1e-4 (:func:`parallel.train.reference_adam`), 100 epochs,
early stop after 5 epochs without a lower validation loss; train = train +
train_synthetic, read through ``EmbeddingStore.padded_batches(shuffle=True,
seed=seed + epoch)``.

Same artifacts, relative to the working directory:
``checkpoints/{version}/{modality}/{pooling}/`` with the training
checkpointer's ``step_{epoch}.npz`` + ``status.json`` and the parameters of
each epoch, the best and the last epoch as
``speecht5_{pooling}_{modality}_{epoch_N|best|last}.npz`` (flat JAX key
layout, which the JAX ``load_npz`` reads); ``results/{version}/{modality}/
{pooling}/logs/results.txt`` in the reference's line format and
``metrics.jsonl``; ``plots/losses.png`` and ``accuracies.png`` when
matplotlib is present.  The test split is evaluated on the best epoch's
parameters.  Pooling is masked to each embedding's frames unless
``--parity_pooling``.  Nothing here launches a kernel: pooling and head are
plain PyTorch, as they are plain XLA in JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Tuple

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train an Intent Classifier with SpeechT5 embeddings "
                    "from SLURP dataset (CUDA)")
    p.add_argument("--modality", "-m", choices=["text", "audio"], required=True)
    p.add_argument("--pooling", "-p", choices=["average", "max", "attention"],
                   required=True)
    p.add_argument("--version", "-v", choices=["fine_tuned", "base"],
                   default="fine_tuned")
    p.add_argument("--folder", default=None,
                   help="embedding root (default extracted/speecht5[_base])")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--print_every", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--parity_pooling", action="store_true",
                   help="pool over zero-padding like the reference")
    p.add_argument("--embedding_size", type=int, default=768)
    p.add_argument("--num_classes", type=int, default=101)
    p.add_argument("--hidden_dims", type=int, nargs="*", default=[],
                   help="MLP head hidden sizes (empty = reference linear head)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p.parse_args(argv)


Step = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def make_classifier_step(method: str, use_lengths: bool, tx) -> Step:
    """``step(model, opt_state, emb, lengths, targets) -> (loss, correct)``:
    the loss and the argmax-match count of the batch before the update,
    then one ``tx`` update of ``model``'s parameters in place."""
    from ..models import intent

    def step(model, opt_state, emb, lengths, targets):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, correct = intent.intent_loss_and_acc(
            model, emb, targets, method=method, lengths=lengths if use_lengths else None)
        loss.backward()
        tx.update(params, {k: p.grad for k, p in params.items()}, opt_state)
        return loss.detach(), correct

    return step


def make_eval_step(method: str, use_lengths: bool) -> Step:
    """``eval_step(model, emb, lengths, targets) -> (loss sum, correct)``."""
    from ..models import intent

    @torch.no_grad()
    def eval_step(model, emb, lengths, targets):
        logits = intent.intent_forward(model, emb, method=method,
                                       lengths=lengths if use_lengths else None)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss_sum = -(targets.float() * logp).sum()
        correct = (logits.argmax(-1) == targets.argmax(-1)).sum()
        return loss_sum, correct

    return eval_step


def main(argv=None) -> int:
    args = parse_args(argv)

    from ..data.embedding_store import EmbeddingStore
    from ..models import intent
    from ..parallel.train import reference_adam
    from ..utils.checkpoint import Checkpointer, flatten, load_npz, save_npz
    from ..utils.device import resolve_device
    from ..utils.metrics import MetricsWriter

    dev = resolve_device(args.device)
    folder = args.folder or ("extracted/speecht5" if args.version == "fine_tuned"
                             else "extracted/speecht5_base")
    train_set = EmbeddingStore([os.path.join(folder, "train", args.modality),
                                os.path.join(folder, "train_synthetic", args.modality)])
    val_set = EmbeddingStore(os.path.join(folder, "devel", args.modality))
    test_set = EmbeddingStore(os.path.join(folder, "test", args.modality))
    print(f"Train set: {len(train_set)}, Val set: {len(val_set)}, "
          f"Test set: {len(test_set)}")

    save_folder = os.path.join("checkpoints", args.version, args.modality, args.pooling)
    results_folder = os.path.join("results", args.version, args.modality, args.pooling)
    plots_folder = os.path.join(results_folder, "plots")
    logs_folder = os.path.join(results_folder, "logs")
    for d in (save_folder, plots_folder, logs_folder):
        os.makedirs(d, exist_ok=True)

    model = intent.intent_classifier_init(
        args.embedding_size, args.num_classes, tuple(args.hidden_dims),
        seed=args.seed, device=dev)
    tx = reference_adam(args.lr, args.weight_decay)
    opt_state = tx.init(dict(model.named_parameters()))
    use_lengths = not args.parity_pooling
    train_step = make_classifier_step(args.pooling, use_lengths, tx)
    eval_step = make_eval_step(args.pooling, use_lengths)

    def on_device(emb, lens, tgts):
        return (torch.from_numpy(emb).to(dev), torch.from_numpy(lens).to(dev),
                torch.from_numpy(tgts).to(dev))

    def evaluate(m, store):
        loss_sum, correct = 0.0, 0
        for batch in store.padded_batches(args.batch_size):
            ls, c = eval_step(m, *on_device(*batch))
            loss_sum += float(ls)
            correct += int(c)
        return loss_sum / len(store), correct / len(store)

    def params_npz(name):
        return os.path.join(save_folder, f"speecht5_{args.pooling}_{args.modality}_{name}.npz")

    ckpt = Checkpointer(save_folder)
    metrics = MetricsWriter(os.path.join(logs_folder, "metrics.jsonl"))
    text_to_write = "Results\n"
    total_loss, val_loss_list, acc_list, acc_val_list = [], [], [], []
    best_val_loss = float("inf")
    epochs_without_improvement = 0
    n_batches = -(-len(train_set) // args.batch_size)

    print("Training started...")
    for epoch in range(args.epochs):
        epoch_loss, acc_train = 0.0, 0.0
        for i, batch in enumerate(train_set.padded_batches(
                args.batch_size, shuffle=True, seed=args.seed + epoch)):
            loss, correct = train_step(model, opt_state, *on_device(*batch))
            epoch_loss += float(loss)
            acc_train += float(correct)
            if (i + 1) % args.print_every == 0:
                line = (f"Epoch [{epoch+1}/{args.epochs}], "
                        f"Iteration [{i+1}/{n_batches}], Loss: {float(loss):.4f}")
                print(line)
                text_to_write += line + "\n"

        epoch_loss /= n_batches
        acc_train /= len(train_set)
        total_loss.append(epoch_loss)
        acc_list.append(acc_train)
        params = intent.intent_to_jax_params(model)
        ckpt.save(epoch + 1, {"params": params,
                              "opt_state": {"count": np.asarray(opt_state["count"]),
                                            "mu": opt_state["mu"], "nu": opt_state["nu"]}})
        save_npz(params_npz(f"epoch_{epoch+1}"), params)

        val_loss, acc_val = evaluate(model, val_set)
        val_loss_list.append(val_loss)
        acc_val_list.append(acc_val)
        metrics.log(epoch=epoch + 1, train_loss=epoch_loss, train_acc=acc_train,
                    val_loss=val_loss, val_acc=acc_val)

        line = (f"Epoch [{epoch+1}/{args.epochs}], Training Loss: {epoch_loss:.4f}, "
                f"Training accuracy: {round(acc_train*100, 2)}, "
                f"Validation Loss: {val_loss:.4f}, "
                f"Validation accuracy: {acc_val*100:.2f}")
        print(line)
        text_to_write += f"###### {line} ######\n\n"

        if val_loss < best_val_loss:
            best_val_loss = val_loss
            epochs_without_improvement = 0
            save_npz(params_npz("best"), params)
        else:
            epochs_without_improvement += 1
        if epochs_without_improvement >= args.patience:
            print(f"Early stopping: Validation loss has not improved in the "
                  f"last {args.patience} epochs.")
            break

    save_npz(params_npz("last"), intent.intent_to_jax_params(model))
    with open(os.path.join(logs_folder, "results.txt"), "w") as f:
        f.write(text_to_write)

    _plots(plots_folder, total_loss, val_loss_list, acc_list, acc_val_list)
    print("Training done!")

    best = intent.intent_from_jax_params(flatten(load_npz(params_npz("best")))).to(dev)
    print("Evaluating model on test set")
    test_loss, test_acc = evaluate(best, test_set)
    print(f"Test Loss: {test_loss:.4f}")
    print(f"Test Accuracy: {test_acc*100:.2f}")
    print("Evaluation done!")
    return 0


def _plots(plots_folder, total_loss, val_loss, acc, acc_val) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure()
    plt.plot(total_loss, label="Training Loss")
    plt.plot(val_loss, label="Validation Loss")
    plt.xlabel("Epoch"); plt.ylabel("Loss")
    plt.title("Training and Validation Loss"); plt.legend()
    plt.savefig(os.path.join(plots_folder, "losses.png"))
    plt.figure()
    plt.plot(acc, label="Training Accuracy")
    plt.plot(acc_val, label="Validation Accuracy")
    plt.xlabel("Epoch"); plt.ylabel("Accuracy")
    plt.title("Training and Validation Accuracy"); plt.legend()
    plt.savefig(os.path.join(plots_folder, "accuracies.png"))
    plt.close("all")


if __name__ == "__main__":
    sys.exit(main())
