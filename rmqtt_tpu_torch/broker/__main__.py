from rmqtt_tpu_torch.broker.server import main

if __name__ == "__main__":
    main()
